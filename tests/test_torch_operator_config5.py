"""Config 5 on the port, held against the reference: a rolling driver
upgrade under the operator while a real training job drain-coordinates
through it, with zero steps lost.

The twin of ``tests/test_e2e_config5.py``. Each package's operator
(``GPUOperator`` on a GB200 clique of 18 nodes; ``TPUOperator`` on the
18-host v5p slice that is its twin, the name map of
``tests/test_torch_operator.py``) places the training workload, then
rolls the driver DaemonSet to v2 with ``wait_for_completion`` on the
job's pods. Each package's ``CheckpointingTrainer`` (the tiny config, on
the CPU) trains 2 steps per reconcile tick, its drain signal "is a node
of my group cordoned", read from the cluster as a pod-side watcher
would. On the drain it saves synchronously and exits; its pods complete;
the upgrade proceeds; when the group is back at ``upgrade-done`` a fresh
trainer resumes from the checkpoint at exactly the preempted step and
trains on. Every tick's nodes, pods, events, placements and operator
reports are compared between the packages, and so are the steps.
"""

import jax
import numpy as np

from torch_operator_twin import CLIQUE_NODES, NS, add_ds, run_twins

GROUP = "pool-a"


class Job:
    """One package's training job: its trainer, state and data."""

    def __init__(self, tw, ckpt):
        self.tw, self.ckpt = tw, ckpt
        self.jax = tw.side == "reference"
        self.running, self.resumed = True, False
        self.preempted_at = None
        self.steps = []
        self.trainer = self._trainer()
        self.state = self.trainer.init_or_resume(
            jax.random.PRNGKey(0) if self.jax else 0)
        self.gen = np.random.default_rng(1)

    def _trainer(self):
        if self.jax:
            from k8s_operator_libs_tpu.models.llama import LlamaConfig
            from k8s_operator_libs_tpu.train.harness import \
                CheckpointingTrainer
            return CheckpointingTrainer(LlamaConfig.tiny(), self.ckpt,
                                        checkpoint_interval=1000)
        from k8s_operator_libs_tpu_torch.models.llama import LlamaConfig
        from k8s_operator_libs_tpu_torch.train.harness import \
            CheckpointingTrainer
        return CheckpointingTrainer(LlamaConfig.tiny(), self.ckpt,
                                    checkpoint_interval=1000, device="cpu")

    def batches(self):
        while True:
            batch = self.gen.integers(0, 512, size=(2, 33), dtype=np.int32)
            yield batch if not self.jax else jax.numpy.asarray(batch)

    def cordoned(self):
        return any(n.spec.unschedulable
                   for n in self.tw.direct.list_nodes())

    def step(self, data):
        """The job's share of one tick, after the operator's reconcile."""
        tw = self.tw
        if self.running:
            result = self.trainer.run(self.state, data, num_steps=2,
                                      drain_signal=self.cordoned)
            self.state = result.state
            self.steps.append(int(self.state.step))
            if result.preempted:
                self.preempted_at = int(self.state.step)
                assert self.trainer.latest_step == self.preempted_at
                for p in tw.op.placements[0].pods:
                    tw.cluster.set_pod_status(NS, p, phase="Succeeded")
                self.running = False
        elif not self.resumed and not self.cordoned() and all(
                n.metadata.labels.get(tw.KeyFactory("drv").state_label)
                == tw.S.DONE for n in tw.direct.list_nodes()):
            # the group is back: a fresh trainer (a fresh pod) resumes
            self.trainer.close()
            self.trainer = self._trainer()
            self.state = self.trainer.init_or_resume(
                jax.random.PRNGKey(42) if self.jax else 42)
            assert int(self.state.step) == self.preempted_at  # zero loss
            self.resumed = self.running = True
            result = self.trainer.run(self.state, data, num_steps=2)
            self.state = result.state
            self.steps.append(int(self.state.step))


def test_zero_loss_rolling_upgrade_with_a_live_job(tmp_path):
    jobs, data = {}, {}

    def setup(tw):
        ds = add_ds(tw)
        tw.add_group(ds, GROUP)
        tw.build([("drv", tw.api.DriverUpgradePolicySpec(
            auto_upgrade=True, max_parallel_upgrades=1,
            max_unavailable="100%",
            wait_for_completion=tw.api.WaitForCompletionSpec(
                pod_selector="job=train"),
            drain=tw.api.DrainSpec(enable=True, force=True,
                                   timeout_second=60)))])
        if tw.side == "reference":
            wl = tw.Workload(name="train", accelerator="tpu-v5p-slice",
                             topology="2x6x6", namespace=NS,
                             labels={"job": "train"})
        else:
            wl = tw.Workload(name="train", product="NVIDIA-GB200",
                             gpus_per_node=4, num_nodes=CLIQUE_NODES,
                             namespace=NS, labels={"job": "train"})
        tw.op.submit(wl)
        jobs[tw.side] = Job(tw, str(tmp_path / tw.side))
        data[tw.side] = jobs[tw.side].batches()

    def hook(tw, t):
        if t == 1:
            tw.cluster.bump_daemonset_revision("drv", NS, "v2")

    def check(tw, t):
        if t == 0:
            assert tw.op.placements, "the workload was not placed"
        else:
            jobs[tw.side].step(data[tw.side])

    def done(tw):
        return jobs[tw.side].resumed

    ref, port = run_twins(setup, 60, hook=hook, check=check, stop=done)
    job, want = jobs["port"], jobs["reference"]
    assert job.steps == want.steps
    assert job.preempted_at is not None and job.resumed
    assert job.steps[-1] > job.preempted_at
    assert port.op.placements[0].slice_id == f"clique/u.{GROUP}"
    pods = port.direct.list_pods(namespace=NS,
                                 label_selector={"app": "drv"})
    assert sorted(p.metadata.labels["controller-revision-hash"]
                  for p in pods) == ["v2"] * CLIQUE_NODES
    for j in jobs.values():
        j.trainer.close()


def test_phase_6b_sequence_on_the_cpu(tmp_path):
    """``chip_smoke.py`` phase 6b's sequence, run here at the tiny config
    on the CPU: a ``CheckpointingTrainer`` on ``gpu-t`` drained by the
    port's ``GPUOperator`` during a rolling driver upgrade (the chaos
    invariants held every tick), resumed at the drained step + 1 with the
    kept loss, its one unavailability window split by the port's
    attribution (the status CLI's ``--goodput`` split the same), and
    that split equal to the reference's ``attribute_downtime`` and
    ``downtime_summary`` on the same ledger and journey."""
    import torch

    import chip_smoke
    from k8s_operator_libs_tpu.obs import attribution as ref_attribution
    from k8s_operator_libs_tpu_torch.models.llama import LlamaConfig
    from k8s_operator_libs_tpu_torch.obs import attribution

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = chip_smoke.trainer_under_operator(
            torch, LlamaConfig.tiny(), "cpu", tmp_path / "operator",
            "NVIDIA-H100-80GB-HBM3", shape=(2, 32))
    finally:
        torch.set_num_threads(threads)
    s = out["drain_step"]
    assert s > chip_smoke.TO_WARM
    assert out["steps"] == s + chip_smoke.TO_RESUMED
    assert out["loss_resumed"] == out["loss_kept"]
    assert set(chip_smoke.TO_PHASES) <= set(out["phases"])
    want = ref_attribution.attribute_downtime(out["records"],
                                              out["journey"])
    assert attribution.attribute_downtime(out["records"],
                                          out["journey"]) == want
    assert want[0]["phases"] == out["phases"]
    (ref_window,) = ref_attribution.windows_from_journey(out["journey"])
    kw = {k: out["downtime"][k] for k in ("ckpt_fetch_s", "ckpt_write_s",
                                          "ckpt_restore_s", "rewarmup_s")}
    ref = ref_attribution.downtime_summary(ref_window, **kw)
    assert {k: v for k, v in out["downtime"].items() if k != "source"} \
        == {k: v for k, v in ref.items() if k != "source"}
