"""The port's CheckpointManager, following tests/test_data_and_infra.py's
cases for the JAX one: save and restore with a data status, keep-last-N,
latest_step and async saves; a save cut before its rename leaves no step;
mismatched states raise; and a training run saved and restored mid-way
ends bit-equal to the straight run."""

import json
import os

import numpy as np
import pytest
import torch
from torch import nn

from bitdance_tpu_torch.models.imagenet_ar import ImageNetARConfig
from bitdance_tpu_torch.train import checkpoints as ck
from bitdance_tpu_torch.train import imagenet_train as tit
from bitdance_tpu_torch.train import optim as topt

torch.set_num_threads(2)


def _state(seed=0, width=4, ema=True):
    torch.manual_seed(seed)
    model = nn.Sequential(nn.Linear(width, width), nn.LayerNorm(width), nn.Linear(width, 3))
    sched = topt.make_lr_schedule(1e-2, 2, 100)
    tx = topt.AdamW(dict(model.named_parameters()), sched, weight_decay=0.1)
    return topt.TrainState.create(model, tx, with_ema=ema)


def _steps(state, n, seed=1):
    gen = torch.Generator().manual_seed(seed)
    for _ in range(n):
        x = torch.randn((5, state.model[0].in_features), generator=gen)
        loss = state.model(x).square().mean()
        topt.apply_gradients(state, torch.autograd.grad(loss, state.tx.params), 0.9)


def _assert_states_equal(a, b):
    ta, tb = ck.state_tensors(a), ck.state_tensors(b)
    assert set(ta) == set(tb)
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k]), k
    assert (a.step, a.tx.count) == (b.step, b.tx.count)
    assert [g["lr"] for g in a.tx.opt.param_groups] == \
        [g["lr"] for g in b.tx.opt.param_groups]


def test_save_restore_with_data_status(tmp_path):
    state = _state()
    _steps(state, 3)
    mgr = ck.CheckpointManager(str(tmp_path / "ckpt"), keep_last_n=2)
    assert mgr.latest_step() is None
    assert mgr.restore(_state(1)) == (None, None, None)
    mgr.save(17, state, data_status={"epoch": 3, "batch": 42})
    names = sorted(ck.state_tensors(state))
    assert "opt/0.weight/exp_avg_sq" in names and "ema/2.bias" in names
    assert "opt/0.weight/step" in names
    fresh = _state(seed=1)
    restored, step, ds = mgr.restore(fresh, with_data_status=True)
    assert restored is fresh and step == 17 and ds == {"epoch": 3, "batch": 42}
    _assert_states_equal(fresh, state)
    assert mgr.restore(_state(1))[2] is None        # data status only when asked
    # training on from both gives the same bits
    _steps(state, 2, seed=5)
    _steps(fresh, 2, seed=5)
    _assert_states_equal(fresh, state)
    mgr.close()
    meta = json.loads((tmp_path / "ckpt" / "17" / "meta.json").read_text())
    assert meta["format"] == ck.FORMAT and meta["step"] == 3 and meta["tx_count"] == 3


def test_restore_fills_tensors_in_place(tmp_path):
    state = _state()
    _steps(state, 2)
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save(2, state)
    other = _state(seed=3)
    _steps(other, 1)
    ptrs = {k: v.data_ptr() for k, v in ck.state_tensors(other).items()}
    mgr.restore(other)
    _assert_states_equal(other, state)
    assert {k: v.data_ptr() for k, v in ck.state_tensors(other).items()} == ptrs


def test_step_zero_checkpoint_clears_optimizer_state(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save(0, _state())
    stepped = _state()
    _steps(stepped, 2)
    mgr.restore(stepped)
    assert not stepped.tx.opt.state and stepped.step == 0 and stepped.tx.count == 0
    _assert_states_equal(stepped, _state())


def test_keep_last_n_and_latest_step(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path / "ckpt"), keep_last_n=2)
    state = _state()
    for s in (1, 2, 3):
        _steps(state, 1)
        mgr.save(s, state)
    assert mgr.latest_step() == 3 and mgr.all_steps() == [2, 3]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["2", "3"]
    with pytest.raises(FileExistsError):
        mgr.save(3, state)
    fresh = _state(seed=2)
    assert mgr.restore(fresh, step=2)[1] == 2 and fresh.step == 2


def test_async_save_copies_before_returning(tmp_path):
    state = _state()
    _steps(state, 2)
    want = {k: v.clone() for k, v in ck.state_tensors(state).items()}
    mgr = ck.CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(2, state, data_status={"file": 4})
    _steps(state, 1)                        # training goes on during the write
    mgr.wait_until_finished()
    fresh = _state(seed=9)
    _, step, ds = mgr.restore(fresh, with_data_status=True)
    assert step == 2 and ds == {"file": 4}
    got = ck.state_tensors(fresh)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    mgr.close()


def test_async_save_error_is_raised(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise OSError("disk full")

    mgr = ck.CheckpointManager(str(tmp_path), async_save=True)
    monkeypatch.setattr(ck, "save_file", broken)
    mgr.save(1, _state())
    with pytest.raises(OSError, match="disk full"):
        mgr.wait_until_finished()
    assert mgr.latest_step() is None


def test_save_cut_before_rename_leaves_no_step(tmp_path, monkeypatch):
    state = _state()
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save(1, state)

    def cut(src, dst):
        raise KeyboardInterrupt("killed")

    monkeypatch.setattr(ck.os, "rename", cut)
    with pytest.raises(KeyboardInterrupt):
        mgr.save(2, state)
    monkeypatch.undo()
    assert mgr.latest_step() == 1 and (tmp_path / "2.tmp").exists()
    mgr2 = ck.CheckpointManager(str(tmp_path))    # a new run clears the cut save
    assert mgr2.all_steps() == [1] and not (tmp_path / "2.tmp").exists()
    assert mgr2.restore(_state(seed=4))[1] == 1


def test_mismatched_states_raise(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path))
    state = _state()
    _steps(state, 1)
    mgr.save(1, state)
    with pytest.raises(ValueError, match="shape|float"):
        mgr.restore(_state(width=6))
    wider = _state()
    wider.model.append(nn.Linear(3, 2))
    with pytest.raises(KeyError, match="differ"):
        mgr.restore(topt.TrainState.create(
            wider.model, topt.AdamW(dict(wider.model.named_parameters()),
                                    lambda s: 0.0)))
    # a state without EMA ignores the checkpoint's EMA, as the JAX manager does
    no_ema = _state(ema=False)
    mgr.restore(no_ema)
    assert no_ema.ema is None and no_ema.step == 1
    mgr2 = ck.CheckpointManager(str(tmp_path / "n"))
    mgr2.save(1, _state(ema=False))
    with pytest.raises(KeyError, match="ema"):
        mgr2.restore(_state())
    (tmp_path / "1" / "meta.json").write_text(json.dumps({"format": "other"}))
    with pytest.raises(ValueError, match="format"):
        mgr.restore(_state())


def test_hdfs_mirror_copies_each_step(tmp_path, monkeypatch):
    from bitdance_tpu_torch.utils import fs

    calls = []
    monkeypatch.setattr(fs, "copy", lambda src, dst: calls.append((src, dst)))
    mgr = ck.CheckpointManager(str(tmp_path / "c"), hdfs_mirror="hdfs://nn/run/")
    mgr.save(5, _state())
    mgr.close()
    assert calls == [(str(tmp_path / "c" / "5"), "hdfs://nn/run/5")]


def test_step_seed():
    assert ck.step_seed(4396, 7) == ck.step_seed(4396, 7)
    seeds = {ck.step_seed(g, s) for g in (0, 1, 4396) for s in range(50)}
    assert len(seeds) == 150 and all(0 <= x < 2 ** 63 for x in seeds)


TINY = dict(dim=64, n_layer=2, n_head=2, diff_layers=2, diff_dim=64,
            diff_adanln_layers=1, latent_dim=8, down_size=16, patch_size=1,
            resolution=64, cls_token_num=4, num_classes=10, diff_batch_mul=2,
            perturb_rate=0.1)


@pytest.mark.parametrize("mixed_precision", [False, True])
def test_imagenet_training_resumes_bit_equal(tmp_path, mixed_precision):
    """Two ImageNet train steps, save, restore into a freshly initialised
    state, two more: bit-equal to four straight steps (each step's draws
    seeded by step_seed)."""
    cfg = ImageNetARConfig(**TINY)
    tcfg = tit.ImageNetTrainConfig(warmup_steps=1, mixed_precision=mixed_precision)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(np.sign(rng.standard_normal((4, 2, 16, 8)))
                              .astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, (4, 2)))

    def init():
        return tit.init_train_state(cfg, tcfg, "cpu",
                                    generator=torch.Generator().manual_seed(0))

    def run(state, steps):
        for s in steps:
            tit.train_step(state, tokens[s], labels[s],
                           torch.Generator().manual_seed(ck.step_seed(11, s)),
                           ema_decay=0.99, mixed_precision=mixed_precision)

    straight = init()
    run(straight, range(4))
    first = init()
    run(first, range(2))
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save(2, first)
    resumed = init()
    mgr.restore(resumed)
    run(resumed, range(2, 4))
    _assert_states_equal(resumed, straight)
    moved = [n for n, p in init().model.named_parameters()
             if not torch.equal(p, straight.model.get_parameter(n))]
    assert len(moved) > 10                       # the steps did train
