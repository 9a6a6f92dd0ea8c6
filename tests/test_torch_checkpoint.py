"""The port's checkpoints (``mvlt_tpu_torch/utils/checkpoint.py``): the
whole train state round trip, pruning, interrupted saves, a missing
checkpoint, the async save, the pretrained export's ``config.json`` against
JAX's ``to_json``, and a resume that equals the run it resumes, bitwise
(dropout and DropPath on, AdamW and the accumulating optimizer)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from mvlt_tpu_torch import config as pcfg
from mvlt_tpu_torch.models.heads import VQAModel
from mvlt_tpu_torch.tasks.common import TaskRunner
from mvlt_tpu_torch.train.steps import make_vqa_step
from mvlt_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(2)
B = 4


def _config():
    cfg = pcfg.tiny_config(pcfg.MVLTConfig.for_vqa(result_num=5, lr=1e-3))
    return dataclasses.replace(
        cfg, swin=dataclasses.replace(cfg.swin, drop_path_rate=0.2),
        fusion=dataclasses.replace(cfg.fusion, num_hidden_layers=1,
                                   vocab_size=200))


def _runner(workdir, accum=1, seed=0):
    tc = pcfg.TrainConfig(batch_size=B, seed=seed, bf16_compute=False,
                          grad_accum_steps=accum, async_checkpoint=False,
                          log_every=1000)
    runner = TaskRunner(VQAModel, _config(), tc, workdir=workdir,
                        name="ckpt-test", device="cpu")
    runner.init_state()
    return runner


def _batch(i):
    rng = np.random.default_rng(100 + i)
    q = rng.integers(1, 200, size=(B, 9)).astype(np.int32)
    q[:, 6:] = 0
    return {"image": torch.from_numpy(rng.normal(size=(B, 3, 32, 32))
                                      .astype(np.float32)),
            "question": torch.from_numpy(q),
            "label": torch.from_numpy(rng.integers(0, 5, B).astype(np.int32))}


def _steps(runner, first, n):
    step = make_vqa_step(runner.model, runner.optimizer)
    for i in range(first, first + n):
        step.masks = runner.masks_for_step()
        step(_batch(i))
        runner.state.step += 1


def _tensors(obj, prefix=""):
    if torch.is_tensor(obj):
        return {prefix: obj}
    out = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.update(_tensors(v, f"{prefix}/{k}"))
    elif isinstance(obj, (list, tuple)):
        for k, v in enumerate(obj):
            out.update(_tensors(v, f"{prefix}/{k}"))
    return out


def _assert_same_state(a, b):
    assert a.step == b.step
    for what, x, y in (("model", a.model.state_dict(), b.model.state_dict()),
                       ("optimizer", _tensors(a.optimizer.state_dict()),
                        _tensors(b.optimizer.state_dict()))):
        assert x.keys() == y.keys(), what
        assert x, what
        for k in x:
            assert torch.equal(x[k], y[k]), (what, k)


@pytest.mark.parametrize("accum", [1, 2])
def test_state_round_trip_and_resume_is_bitwise(tmp_path, accum):
    """3 steps, a save (mid-accumulation when k = 2), 2 more steps; a fresh
    runner restores the save and takes the same 2 steps: the state after
    the restore and after the 2 steps is bitwise the original run's."""
    a = _runner(str(tmp_path), accum)
    _steps(a, 0, 3)
    a.save()
    b = _runner(str(tmp_path), accum, seed=0)
    assert b.maybe_restore()
    _assert_same_state(a.state, b.state)
    if accum > 1:
        assert a.optimizer.mini_step == 1
        assert any(t.abs().sum() > 0 for t in b.optimizer.acc)
    _steps(a, 3, 2)
    _steps(b, 3, 2)
    _assert_same_state(a.state, b.state)
    # and the parameters moved from the restored point
    c = _runner(str(tmp_path), accum)
    c.maybe_restore()
    assert any(not torch.equal(x, y) for x, y in zip(
        c.model.parameters(), a.model.parameters()))


def test_missing_checkpoint_returns_false(tmp_path):
    r = _runner(None)
    assert r.maybe_restore() is False
    state, ok = ckpt.restore_checkpoint(str(tmp_path / "nothing"), r.state)
    assert ok is False and state is r.state
    assert ckpt.latest_checkpoint(str(tmp_path / "nothing")) is None


def test_pruning_and_tmp_leftovers(tmp_path):
    r = _runner(str(tmp_path))
    os.makedirs(tmp_path / "step_00000099-tmp-123-456")   # interrupted save
    for s in (1, 2, 3, 4):
        r.state.step = s
        ckpt.save_checkpoint(str(tmp_path), r.state, keep=2)
    names = sorted(os.listdir(tmp_path))
    assert [n for n in names if n.startswith("step_")] == [
        "step_00000003", "step_00000004", "step_00000099-tmp-123-456"]
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith("step_00000004")
    r.state.step = 0
    _, ok = ckpt.restore_checkpoint(str(tmp_path), r.state)
    assert ok and r.state.step == 4
    _, ok = ckpt.restore_checkpoint(str(tmp_path / "step_00000003"), r.state)
    assert ok and r.state.step == 3


def test_async_save_snapshots_then_writes(tmp_path):
    """The async save copies the state before it returns: a step taken
    while it writes does not reach the file."""
    r = _runner(str(tmp_path))
    _steps(r, 0, 1)
    want = {k: v.clone() for k, v in r.model.state_dict().items()}
    ckpt.save_checkpoint(str(tmp_path), r.state, async_save=True)
    _steps(r, 1, 1)
    ckpt.wait_for_async_saves()
    fresh = _runner(None)
    _, ok = ckpt.restore_checkpoint(str(tmp_path), fresh.state)
    assert ok and fresh.state.step == 1
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    # a second async save waits for the first; listing waits for both
    ckpt.save_checkpoint(str(tmp_path), r.state, async_save=True)
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith("step_00000002")


def test_save_pretrained_config_json_is_jax_text(tmp_path):
    from mvlt_tpu import config as jcfg
    jax_cfg = jcfg.tiny_config(jcfg.MVLTConfig.for_vqa(result_num=5, lr=1e-3))
    jax_cfg = dataclasses.replace(
        jax_cfg, swin=dataclasses.replace(jax_cfg.swin, drop_path_rate=0.2),
        fusion=dataclasses.replace(jax_cfg.fusion, num_hidden_layers=1,
                                   vocab_size=200))
    r = _runner(None)
    ckpt.save_pretrained(str(tmp_path / "export"), r.config, r.model)
    text = (tmp_path / "export" / "config.json").read_text()
    assert text == jax_cfg.to_json()
    cfg, sd = ckpt.load_pretrained(str(tmp_path / "export"))
    assert cfg == r.config
    assert pcfg.MVLTConfig.from_json(jax_cfg.to_json()) == r.config
    for k, v in r.model.state_dict().items():
        assert torch.equal(sd[k], v), k
    # the export seeds a finetune runner: every tensor loaded
    other = TaskRunner(VQAModel, cfg, pcfg.TrainConfig(seed=5),
                       device="cpu", name="ckpt-test")
    other.init_state(pretrained_variables=[sd])
    for k, v in other.model.state_dict().items():
        assert torch.equal(sd[k], v), k
