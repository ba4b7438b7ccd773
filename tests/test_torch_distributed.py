"""The port's process-group plumbing against the JAX package and on its
own: ``cluster_env`` on the scheduler's env dicts, the mesh's layout of
ranks against the reference mesh's layout of devices, each differentiable
collective of ``utils/comm.py`` (value, gradient and bytes counted) on
2 and 4 gloo ranks, and the launcher's failure and time limit.

Each group of ranks runs under ``launch.run`` with a time limit
(``GROUP_TIMEOUT``): a deadlocked collective fails the test instead of
hanging the suite. The rank bodies live in ``torch_parallel_ranks.py``,
which imports no JAX (``spawn`` re-imports it in every rank)."""

import time

import jax
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from k8s_operator_libs_tpu.parallel import distributed as jdist
from k8s_operator_libs_tpu.parallel import mesh as jmesh
from k8s_operator_libs_tpu_torch.parallel import distributed as tdist
from k8s_operator_libs_tpu_torch.parallel import launch
from k8s_operator_libs_tpu_torch.utils import mesh as tmesh

GROUP_TIMEOUT = 120.0

ENVS = [
    {},                                                   # no placement
    {"TPU_WORKER_HOSTNAMES": "solo"},                     # one host
    {"TPU_WORKER_ID": "0", "TPU_WORKER_HOSTNAMES": "j-0.j,j-1.j,j-2.j,j-3.j",
     "JAX_COORDINATOR_ADDRESS": "j-0.j:8476"},
    {"TPU_WORKER_ID": "3", "TPU_WORKER_HOSTNAMES": "j-0.j,j-1.j,j-2.j,j-3.j",
     "JAX_COORDINATOR_ADDRESS": "j-0.j:8476"},
    {"TPU_WORKER_ID": "2", "TPU_WORKER_HOSTNAMES": "a,b,c,d",
     "JAX_COORDINATOR_ADDRESS": ""},                      # no coordinator
    {"TPU_WORKER_HOSTNAMES": "a,b", "JAX_COORDINATOR_ADDRESS": "a:1"},
    # multislice: slice 1, worker 3 of 4 hosts -> rank 7 of 8
    {"TPU_WORKER_ID": "3", "TPU_WORKER_HOSTNAMES": "h0,h1,h2,h3",
     "JAX_COORDINATOR_ADDRESS": "ms-0-0.ms:8476",
     "MEGASCALE_NUM_SLICES": "2", "MEGASCALE_SLICE_ID": "1"},
    # multislice of single-host slices: 1 host x 3 slices
    {"TPU_WORKER_ID": "0", "TPU_WORKER_HOSTNAMES": "h0",
     "JAX_COORDINATOR_ADDRESS": "s-0.s:8476", "MEGASCALE_NUM_SLICES": "3",
     "MEGASCALE_SLICE_ID": "2"},
]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("env", range(len(ENVS)))
def test_cluster_env_matches_reference(env):
    environ = ENVS[env]
    ref = jdist.cluster_env(environ)
    got = tdist.cluster_env(environ)
    if ref is None:
        assert got is None
        return
    assert got == {"init_method": f"tcp://{ref['coordinator_address']}",
                   "world_size": ref["num_processes"],
                   "rank": ref["process_id"]}



@pytest.mark.parametrize("hosts,slices", [(2, 1), (1, 2)])
def test_each_gpu_process_is_a_rank_of_its_own(hosts, slices):
    """A job on 2 nodes x 2 GPUs (one slice of 2 hosts, or 2 slices of 1):
    each node's pod starts 2 processes, LOCAL_RANK 0 and 1 of
    LOCAL_WORLD_SIZE 2. Every process is a rank of its own, a host's
    consecutive, and over one slice each membership names its GPU."""
    seen = []
    for s in range(slices):
        for worker in range(hosts):
            for local in range(2):
                env = {"TPU_WORKER_ID": str(worker),
                       "TPU_WORKER_HOSTNAMES": ",".join(
                           f"j-{i}.j" for i in range(hosts)),
                       "JAX_COORDINATOR_ADDRESS": "j-0.j:8476",
                       "LOCAL_WORLD_SIZE": "2", "LOCAL_RANK": str(local)}
                if slices > 1:
                    env.update(MEGASCALE_NUM_SLICES=str(slices),
                               MEGASCALE_SLICE_ID=str(s))
                got = tdist.cluster_env(env)
                assert got["world_size"] == 4
                assert got["init_method"] == "tcp://j-0.j:8476"
                seen.append(got["rank"])
                m = tdist.cluster_membership(env, backend="gloo")
                if slices > 1:
                    assert m is None
                    continue
                assert m.members == ("j-0.j/cuda:0", "j-0.j/cuda:1",
                                     "j-1.j/cuda:0", "j-1.j/cuda:1")
                assert (m.me, m.rank) == (f"j-{worker}.j/cuda:{local}",
                                          got["rank"])
    assert seen == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="LOCAL_RANK 2"):
        tdist.cluster_env(dict(env, LOCAL_RANK="2"))

def test_maybe_initialize_passes_the_env_to_the_process_group():
    calls = []
    assert tdist.maybe_initialize_from_env(
        ENVS[6], _initialize=lambda **kw: calls.append(kw), backend="gloo")
    assert calls == [{"backend": "gloo", "init_method": "tcp://ms-0-0.ms:8476",
                      "world_size": 8, "rank": 7}]
    assert not tdist.maybe_initialize_from_env(
        ENVS[1], _initialize=lambda **kw: 1 / 0)


@pytest.mark.parametrize("device,gpus,env,want", [
    ("cpu", 8, {}, "gloo"),
    ("cuda", 0, {}, "gloo"),                          # no GPU
    ("cuda", 1, {}, "nccl"),                          # one rank per host
    ("cuda", 1, {"LOCAL_WORLD_SIZE": "2"}, "gloo"),   # two ranks, one GPU
    ("cuda", 4, {"LOCAL_WORLD_SIZE": "4"}, "nccl"),
    ("cuda:1", 2, {"LOCAL_WORLD_SIZE": "3"}, "gloo")])
def test_default_backend_follows_the_ranks_and_devices(monkeypatch, device,
                                                       gpus, env, want):
    """NCCL on GPUs, gloo on the CPU and where a host starts more ranks
    than it has GPUs (NCCL refuses two ranks on one device)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: gpus > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: gpus)
    assert tdist.default_backend(device, env) == want


@pytest.mark.parametrize("sizes", [
    dict(fsdp=8), dict(data=2, fsdp=4), dict(fsdp=2, seq=4),
    dict(stage=2, data=1, fsdp=2, tensor=2), dict(data=2, seq=2, tensor=2)])
def test_mesh_layout_matches_reference(sizes):
    """Each rank's coordinates are those of device ``rank`` in the
    reference's device-order mesh, and each axis's groups are the ranks
    that share every other coordinate."""
    ref = jmesh.make_mesh(physical=False, **sizes)
    ids = np.vectorize(lambda d: d.id)(ref.devices)
    shape = tmesh.mesh_shape(8, **sizes)
    assert tuple(shape[a] for a in tmesh.AXES) == ids.shape
    assert tuple(ref.axis_names) == tmesh.AXES
    for rank in range(8):
        coords = tmesh.coordinates(shape, rank)
        assert ids[tuple(coords[a] for a in tmesh.AXES)] == rank
    for k, axis in enumerate(tmesh.AXES):
        groups = tmesh.axis_ranks(shape, axis)
        want = np.moveaxis(ids, k, -1).reshape(-1, ids.shape[k]).tolist()
        assert groups == want
    with pytest.raises(ValueError):
        tmesh.mesh_shape(8, data=3)


def test_param_specs_follow_the_reference_rule():
    """The port's specs are the reference's PartitionSpecs, entry for
    entry, on the same tree."""
    from k8s_operator_libs_tpu.models import llama as jllama
    from k8s_operator_libs_tpu_torch import convert
    tree = jax.device_get(jllama.init_params(jax.random.PRNGKey(0),
                                             jllama.LlamaConfig.tiny()))
    ref = jmesh.param_specs(tree)
    got = tmesh.param_specs(convert.to_torch(tree, device="cpu"))
    flat_ref = jax.tree_util.tree_leaves_with_path(
        ref, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    for path, spec in flat_ref:
        node = got
        for key in path:
            node = node[key.key]
        assert tuple(spec) == node, path
    assert tmesh.shard_dim(got["blocks"]["wo"], "fsdp") == 2
    assert tmesh.shard_dim(got["final_norm"], "fsdp") is None
    assert tuple(jmesh.batch_spec()) == tmesh.batch_spec()
    # the sequence-parallel rule: every leaf replicated (P() in JAX)
    from k8s_operator_libs_tpu.parallel.fsdp import replicated_specs
    rep = tmesh.replicated_specs(convert.to_torch(tree, device="cpu"))
    for path, spec in jax.tree_util.tree_leaves_with_path(
            replicated_specs(tree),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)):
        node = rep
        for key in path:
            node = node[key.key]
        assert tuple(spec) == () and set(node) == {None}, path


def _collective_inputs(n, seed=0):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    xs = {"ppermute": r(n, 4, 6), "all_gather": r(n, 4, 6),
          "reduce_scatter": r(n, 4 * n, 6), "all_to_all": r(n, 4 * n, 6),
          "psum": r(n, 4, 6), "replicate": np.repeat(r(1, 4, 6), n, 0),
          "pmean": r(n, 4, 6), "pmax": r(n, 4, 6)}
    ws = {"ppermute": r(n, 4, 6), "all_gather": r(n, 4 * n, 6),
          "reduce_scatter": r(n, 4, 6), "all_to_all": r(n, 4, 6 * n),
          "psum": r(n, 4, 6), "replicate": r(n, 4, 6), "pmean": r(n, 4, 6)}
    return xs, ws


def _expected(n, xs, ws, r):
    """(value, gradient) of each collective on rank r, in numpy."""
    blk = lambda a, i: a[4 * i:4 * (i + 1)]                  # noqa: E731
    col = lambda a, i: a[:, 6 * i:6 * (i + 1)]               # noqa: E731
    return {
        "ppermute": (xs["ppermute"][(r - 1) % n], ws["ppermute"][(r + 1) % n]),
        "all_gather": (np.concatenate(list(xs["all_gather"])),
                       sum(blk(ws["all_gather"][j], r) for j in range(n))),
        "reduce_scatter": (sum(blk(xs["reduce_scatter"][j], r)
                               for j in range(n)),
                           np.concatenate(list(ws["reduce_scatter"]))),
        "all_to_all": (np.concatenate([blk(xs["all_to_all"][j], r)
                                       for j in range(n)], axis=1),
                       np.concatenate([col(ws["all_to_all"][i], r)
                                       for i in range(n)])),
        "psum": (xs["psum"].sum(0), ws["psum"][r]),
        "replicate": (xs["replicate"][r], ws["replicate"].sum(0)),
        "pmean": (xs["pmean"].mean(0), ws["pmean"][r] / n),
    }


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_and_their_transposes(n, tmp_path):
    """Each collective's value and its backward against numpy, and the
    bytes the counter books (ring algorithms: per call and rank). pmax
    has no backward: its result carries no gradient."""
    xs, ws = _collective_inputs(n)
    results = launch.run(ranks.collectives, n, xs, ws,
                         timeout=GROUP_TIMEOUT, workdir=str(tmp_path))
    for r, got in enumerate(results):
        for kind, (value, grad) in _expected(n, xs, ws, r).items():
            np.testing.assert_allclose(got[kind][0], value, rtol=1e-6,
                                       atol=1e-6, err_msg=f"{kind} value")
            np.testing.assert_allclose(got[kind][1], grad, rtol=1e-6,
                                       atol=1e-6, err_msg=f"{kind} grad")
        value, requires_grad = got["pmax"]
        np.testing.assert_array_equal(value, xs["pmax"].max(0))
        assert not requires_grad
        b = 4 * 4 * 6                       # one [4, 6] fp32 tile
        assert got["bytes"] == {
            "ppermute": 2 * b,              # forward and backward
            "all_gather": (n - 1) * b + (n - 1) * b,   # + backward's a2a
            "reduce_scatter": (n - 1) * b + (n - 1) * b,
            "all_to_all": 2 * (n - 1) * b,
            "psum": int(2 * (n - 1) / n * b) * 3,   # psum, replicate, pmean
            "pmax": int(2 * (n - 1) / n * b),
        }, got["bytes"]


def test_a_failing_rank_fails_the_call(tmp_path):
    with pytest.raises(launch.RankFailed, match="rank 1 planted failure"):
        launch.run(ranks.fail, 2, timeout=GROUP_TIMEOUT,
                   workdir=str(tmp_path))


def test_ranks_leave_the_group_together_the_store_owner_last(tmp_path):
    """The CLI's exit (``distributed.leave_process_group``): rank 0, which
    serves the group's store, returns only after rank 1 has torn its
    group down, however slow that teardown; a rank left tearing down
    against a store whose owner had exited could abort."""
    (r0, t0), (r1, t1) = launch.run(ranks.leave_in_order, 2, 1.0,
                                    timeout=GROUP_TIMEOUT,
                                    workdir=str(tmp_path))
    assert (r0, r1) == (0, 1)
    assert t0 >= t1, f"rank 0 left {t1 - t0:.3f} s before rank 1 was down"


def test_a_deadlocked_collective_ends_at_the_time_limit(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(launch.RankFailed, match="within 4 s"):
        launch.run(ranks.hang, 2, timeout=4.0, workdir=str(tmp_path))
    assert time.monotonic() - t0 < 60
    assert not list(tmp_path.iterdir())       # the rendezvous is removed
