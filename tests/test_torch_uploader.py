"""The port's checkpoint uploader: ``mirror_once`` against the JAX
package's on the same directories, its crash safety, and the drain-save
protocol end to end with the port's trainer (save locally, exit, the
uploader finishes the durable copy, the job resumes from it)."""

import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from k8s_operator_libs_tpu.train import uploader as juploader
from k8s_operator_libs_tpu_torch.models.llama import LlamaConfig
from k8s_operator_libs_tpu_torch.parallel import fsdp
from k8s_operator_libs_tpu_torch.train import (CheckpointUploader, harness,
                                               mirror_once, uploader)
from k8s_operator_libs_tpu_torch.train.harness import CheckpointingTrainer

LR = 3e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _tree(root):
    """Every file under ``root``, relative path -> bytes."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_mirror_once_is_idempotent_and_crash_safe(tmp_path, monkeypatch):
    """Re-runs copy nothing new; an unfinished ``.tmp-*`` step is
    skipped; a crashed attempt's staging directory does not block a new
    copy and is swept once stale; a step already published (by a
    concurrent uploader, before or between our copy and rename) is kept
    and our copy discarded."""
    local, durable = tmp_path / "l", tmp_path / "d"
    (local / "7").mkdir(parents=True)
    (local / "7" / "state.pt").write_text("payload")
    (local / ".tmp-8-123").mkdir()              # a write in flight
    assert mirror_once(str(local), str(durable)) == 1
    assert (durable / "7" / "state.pt").read_text() == "payload"
    assert mirror_once(str(local), str(durable)) == 0
    (local / "9").mkdir()
    (local / "9" / "state.pt").write_text("new")
    stale = durable / "9.uploading-12345-deadbeef"
    stale.mkdir()
    (stale / "garbage").write_text("stale")
    old = time.time() - 2 * uploader._STALE_STAGING_SECONDS
    os.utime(stale, (old, old))
    os.utime(stale / "garbage", (old, old))
    assert mirror_once(str(local), str(durable)) == 1
    assert (durable / "9" / "state.pt").read_text() == "new"
    assert not stale.exists()
    (local / "11").mkdir()
    (local / "11" / "state.pt").write_text("ours")
    (durable / "11").mkdir()
    (durable / "11" / "state.pt").write_text("winner")
    assert mirror_once(str(local), str(durable)) == 0
    assert (durable / "11" / "state.pt").read_text() == "winner"
    (local / "12").mkdir()
    (local / "12" / "state.pt").write_text("ours")
    real_copytree = shutil.copytree

    def racing_copytree(src, dst, **kw):
        out = real_copytree(src, dst, **kw)
        if not (durable / "12").exists():
            (durable / "12").mkdir()
            (durable / "12" / "state.pt").write_text("winner")
        return out

    monkeypatch.setattr(shutil, "copytree", racing_copytree)
    assert mirror_once(str(local), str(durable)) == 0
    monkeypatch.undo()
    assert (durable / "12" / "state.pt").read_text() == "winner"
    assert not any(".uploading" in n for n in os.listdir(durable))


def _tokens(step, B=2, T=17):
    g = np.random.default_rng(300 + step)
    return torch.tensor(g.integers(0, 512, size=(B, T)), dtype=torch.int32)


def _run(ckpt, num_steps, drain_at=None, interval=2):
    """The tiny fp32 trainer on ``ckpt`` to step ``num_steps``, drained
    before step ``drain_at + 1``; its result and losses by step."""
    trainer = CheckpointingTrainer(LlamaConfig.tiny(dtype=torch.float32),
                                   str(ckpt),
                                   optimizer=fsdp.default_optimizer(LR),
                                   checkpoint_interval=interval,
                                   device="cpu")
    state = trainer.init_or_resume(0)
    start = int(state.step)
    losses = {}
    result = trainer.run(
        state, (_tokens(s) for s in range(start, 10 ** 6)),
        num_steps - start,
        drain_signal=lambda: drain_at is not None and
        start + len(losses) == drain_at,
        on_step=lambda s, m: losses.__setitem__(s, float(m["loss"])))
    trainer.close()
    return result, losses


def test_uploader_mirrors_the_drain_save_and_the_job_resumes_from_it(
        tmp_path):
    """The job checkpoints at 2, drains at 3 and exits; the uploader,
    outliving it, makes both steps durable (never a partial copy); a job
    on the durable directory resumes at 3 and reaches the step-6 loss and
    parameters of an uninterrupted run."""
    straight, ref = _run(tmp_path / "straight", 6)
    local, durable = tmp_path / "local", tmp_path / "durable"
    with CheckpointUploader(str(local), str(durable),
                            poll_seconds=0.05) as up:
        first, losses = _run(local, 6, drain_at=3)
        assert first.preempted and first.last_checkpoint_step == 3
        assert up.wait_idle(timeout=60.0), "the uploader never caught up"
    assert uploader._finalized_steps(str(durable)) == ["2", "3"]
    assert not any(".uploading" in n for n in os.listdir(durable))
    assert _tree(durable) == {k: v for k, v in _tree(local).items()
                              if k.split(os.sep)[0].isdigit()}
    second, more = _run(durable, 6)
    assert second.steps_done == 3
    losses.update(more)
    assert losses == ref
    for a, b in zip(fsdp.param_leaves(second.state.params),
                    fsdp.param_leaves(straight.state.params)):
        assert torch.equal(a, b)


def test_a_write_in_flight_is_never_mirrored(tmp_path, monkeypatch):
    """The trainer writes into ``.tmp-*`` and publishes with a rename, so
    a save still being written is invisible to the mirror; once it is
    published, the mirror copies it."""
    entered, release = threading.Event(), threading.Event()
    real_save = torch.save

    def held_save(obj, path):
        entered.set()
        assert release.wait(60)
        real_save(obj, path)

    monkeypatch.setattr(harness.torch, "save", held_save)
    local, durable = tmp_path / "local", tmp_path / "durable"
    trainer = CheckpointingTrainer(LlamaConfig.tiny(dtype=torch.float32),
                                   str(local), checkpoint_interval=1,
                                   device="cpu")
    state = trainer.init_or_resume(0)
    trainer.run(state, (_tokens(s) for s in range(10)), 1)
    assert entered.wait(60)
    assert [n for n in os.listdir(local) if n.startswith(".tmp-")]
    assert mirror_once(str(local), str(durable)) == 0
    release.set()
    trainer.close()
    assert mirror_once(str(local), str(durable)) == 1
    assert uploader._finalized_steps(str(durable)) == ["1"]


def test_jax_and_port_mirror_publish_identical_trees(tmp_path):
    local = tmp_path / "local"
    _run(local, 3, interval=1)
    assert uploader._finalized_steps(str(local)) == ["1", "2", "3"]
    (local / ".tmp-4-99").mkdir()                # unfinished: skipped
    assert mirror_once(str(local), str(tmp_path / "port")) == 3
    assert juploader.mirror_once(str(local), str(tmp_path / "jax")) == 3
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax") != {}
