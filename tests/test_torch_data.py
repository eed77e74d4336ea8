"""The port's ImageNet data pipeline, config loaders and utilities against
the JAX package on the CPU: image folders and nested tars written here give
the same bytes through both (folder and tar datasets, crops at several
(seed, epoch, idx) and aug ratios, the sharded iterator with start_batch,
the aug-ratio schedule); the native tar index equals the Python walk and
the JAX package's; the YAML loader and mesh shape; fs local operations,
the scalar writer, the metric accumulator and the step profiler."""

import io
import json
import os
import sys
import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch

from bitdance_tpu.data import imagenet as jdata
from bitdance_tpu_torch.data import imagenet as tdata
from bitdance_tpu_torch.data import native as tnative

ROOT = Path(__file__).resolve().parents[1]


def _image_folder(root, n_classes=3, per_class=4, size=40):
    from PIL import Image

    rng = np.random.default_rng(0)
    for c in range(n_classes):
        d = root / f"class_{c:03d}"
        d.mkdir(parents=True, exist_ok=True)
        for i in range(per_class):
            arr = rng.integers(0, 255, (size + 7 * c, size + 11 * i, 3), np.uint8)
            Image.fromarray(arr).save(d / f"img_{i}.png")
    return str(root)


def _jpeg(rng, h, w) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(buf, "JPEG")
    return buf.getvalue()


def _nested_tar(path, n_classes=3, per_class=3, sizes=((30, 44), (52, 36))):
    """The official layout: an outer tar of <wnid>.tar members, each holding
    <wnid>_<i>.JPEG images at mixed sizes."""
    rng = np.random.default_rng(1)
    with tarfile.open(path, "w") as outer:
        for c in range(n_classes):
            wnid = f"n{c + 1:08d}"
            buf = io.BytesIO()
            with tarfile.open(fileobj=buf, mode="w") as inner:
                for i in range(per_class):
                    data = _jpeg(rng, *sizes[(c + i) % len(sizes)])
                    info = tarfile.TarInfo(f"{wnid}_{i}.JPEG")
                    info.size = len(data)
                    inner.addfile(info, io.BytesIO(data))
            info = tarfile.TarInfo(f"{wnid}.tar")
            info.size = len(buf.getvalue())
            outer.addfile(info, io.BytesIO(buf.getvalue()))
    return str(path)


def test_native_index_equals_python_and_jax(tmp_path):
    """The C++ indexer (built by g++ into build/) gives the Python walk's
    index and the JAX package's (its Python walk, a cached-free call)."""
    tar = _nested_tar(tmp_path / "train.tar")
    assert tnative.library_path().parent == ROOT / "build"
    entries, classes = tnative.build_tar_index_native(tar, str(tmp_path / "idx"))
    assert tnative.library_path().exists()
    assert classes == [f"n{c + 1:08d}" for c in range(3)]
    py = tdata.python_tar_index(tar)
    assert [tuple(e) for e in entries] == py and len(py) == 9
    native_flat = tdata.build_flat_index(tar, str(tmp_path / "n.index"), native=True)
    python_flat = tdata.build_flat_index(tar, str(tmp_path / "p.index"), native=False)
    jax_flat = jdata.build_flat_index(tar, str(tmp_path / "j.index"))
    assert native_flat == python_flat == jax_flat == py
    # the cached index is read back as written
    assert tdata.build_flat_index(tar, str(tmp_path / "n.index")) == native_flat
    with open(tar, "rb") as f:
        off, size, _ = native_flat[0]
        f.seek(off)
        assert f.read(3) == b"\xff\xd8\xff"              # a JPEG starts there


def test_native_index_raises_without_a_compiler(tmp_path, monkeypatch):
    """native=True never falls back to the Python walk."""
    tar = _nested_tar(tmp_path / "train.tar", n_classes=1, per_class=1)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "library_path", lambda: tmp_path / "b" / "lib.so")
    monkeypatch.setattr(tnative, "CXX_FLAGS", ["--no-such-flag"])
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "b")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tdata.build_flat_index(tar, str(tmp_path / "x.index"), native=True)
    assert not os.path.exists(tmp_path / "x.index")


def test_native_scan_failure_raises(tmp_path):
    with pytest.raises(RuntimeError, match="failed"):
        tnative.build_tar_index_native(str(tmp_path / "missing.tar"),
                                       str(tmp_path / "idx"))


@pytest.mark.parametrize("aug_ratio", [1.0, 0.5, 0.0])
def test_crop_datasets_give_the_jax_bytes(tmp_path, aug_ratio):
    """Folder and tar datasets through ImageCropDataset: equal arrays and
    labels at several (seed, epoch, idx), random and center crops."""
    folder = _image_folder(tmp_path / "imgs")
    tar = _nested_tar(tmp_path / "train.tar")
    pairs = [(tdata.ImageFolderDataset(folder), jdata.ImageFolderDataset(folder)),
             (tdata.ImageNetTarDataset(tar), jdata.ImageNetTarDataset(tar))]
    assert pairs[1][0].files == pairs[1][1].files
    for traw, jraw in pairs:
        for seed, res in ((42, 32), (7, 24)):
            t = tdata.ImageCropDataset(traw, res, seed=seed)
            j = jdata.ImageCropDataset(jraw, res, seed=seed)
            t.set_aug_ratio(aug_ratio)
            j.set_aug_ratio(aug_ratio)
            for epoch in (0, 3):
                t.set_epoch(epoch)
                j.set_epoch(epoch)
                for idx in range(len(traw)):
                    (ti, tl), (ji, jl) = t[idx], j[idx]
                    assert ti.dtype == np.float32 and ti.shape == (res, res, 3)
                    np.testing.assert_array_equal(ti, ji)
                    assert tl == jl


def test_sharded_iterator_and_start_batch(tmp_path):
    folder = _image_folder(tmp_path / "imgs", per_class=5)
    t = tdata.build_dataset(folder, 16, seed=3)
    j = jdata.build_dataset(folder, 16, seed=3)
    for shards in (1, 3):
        for shard in range(shards):
            ti = tdata.ShardedBatchIterator(t, 6, num_shards=shards,
                                            shard_index=shard, seed=5)
            ji = jdata.ShardedBatchIterator(j, 6, num_shards=shards,
                                            shard_index=shard, seed=5)
            for epoch in (0, 2):
                np.testing.assert_array_equal(ti.epoch_indices(epoch),
                                              ji.epoch_indices(epoch))
                full = list(ti.iter_epoch(epoch))
                want = list(ji.iter_epoch(epoch))
                assert len(full) == len(want) > 1
                for (a, la), (b, lb) in zip(full, want):
                    np.testing.assert_array_equal(a, b)
                    np.testing.assert_array_equal(la, lb)
                    assert la.dtype == np.int32
                # resuming at batch 1 gives the rest of the same epoch
                rest = list(ti.iter_epoch(epoch, start_batch=1))
                assert len(rest) == len(full) - 1
                for (a, la), (b, lb) in zip(rest, full[1:]):
                    np.testing.assert_array_equal(a, b)
                    np.testing.assert_array_equal(la, lb)


@pytest.mark.parametrize("epoch,start,end", [
    (0, 700, 750), (725, 700, 750), (749, 700, 750), (750, 700, 750),
    (800, 700, 750), (10, -1, -1), (5, 5, 5), (3, 2, 9)])
def test_linear_decay_ratio(epoch, start, end):
    assert tdata.linear_decay_ratio(epoch, start, end) == \
        jdata.linear_decay_ratio(epoch, start, end)


def test_numpy_seed_restores_state():
    np.random.seed(123)
    before = np.random.get_state()[1].copy()
    with tdata.numpy_seed(42, 3, 5):
        a = np.random.rand()
    with jdata.numpy_seed(42, 3, 5):
        b = np.random.rand()
    assert a == b
    np.testing.assert_array_equal(np.random.get_state()[1], before)


def test_yaml_config_matches_jax():
    """load_yaml, the config functions and mesh_shape_from_yaml as
    test_yaml_config_roundtrip holds the JAX ones."""
    from bitdance_tpu import config as jcfg
    from bitdance_tpu_torch import config as tcfg

    path = str(ROOT / "train/configs/bitdance_14b_64x.yaml")
    t, j = tcfg.load_yaml(path), jcfg.load_yaml(path)
    assert t == j and isinstance(t, tcfg.ConfigDict)
    assert t.training.lr == j.training.lr and t.model.head.vision_pred.parallel_num == 64
    m = tcfg.mllm_config_from_yaml(t, vocab_size=152064)
    assert (m.parallel_num, m.head_model_dim, m.head_use_swiglu) == (64, 5120, True)
    assert (m.P_mean, m.P_std, m.vision_perturb, m.z_channels) == (-0.8, 0.8, 0.1, 32)
    assert m.attn_max_live_kv == 33
    t.model.attn_max_live_kv = 0
    assert tcfg.mllm_config_from_yaml(t, 152064).attn_max_live_kv is None
    t.model.attn_max_live_kv = 17
    assert tcfg.mllm_config_from_yaml(t, 152064).attn_max_live_kv == 17
    del t.model["attn_max_live_kv"]
    tc = tcfg.mllm_train_config_from_yaml(t)
    jc = jcfg.mllm_train_config_from_yaml(j)
    assert tc.lr == 1e-5 and tc.eps == 1e-15 and tc.loss_weight_text == 0.01
    assert (tc.lr, tc.min_lr, tc.betas, tc.eps, tc.warmup_steps, tc.total_steps,
            tc.decay_start, tc.max_grad_norm, tc.grad_accum) == \
        (jc.lr, jc.min_lr, jc.betas, jc.eps, jc.warmup_steps, jc.total_steps,
         jc.decay_start, jc.max_grad_norm, jc.grad_accum)
    assert tcfg.mesh_shape_from_yaml(t) == jcfg.mesh_shape_from_yaml(j) == (1, 8)
    with pytest.raises(AttributeError):
        t.no_such_key


def test_load_json(tmp_path):
    from bitdance_tpu import config as jcfg
    from bitdance_tpu_torch import config as tcfg

    p = tmp_path / "c.json"
    p.write_text(json.dumps({"a": {"b": [1, {"c": 2}]}, "d": 0.5}))
    t = tcfg.load_json(str(p))
    assert t == jcfg.load_json(str(p)) and t.a.b[1].c == 2


def test_fs_local_ops(tmp_path):
    from bitdance_tpu_torch.utils import fs

    d = str(tmp_path / "x")
    fs.mkdir(d)
    assert fs.exists(d)
    with open(os.path.join(d, "a.txt"), "w") as f:
        f.write("hi")
    listing = fs.listdir(d)
    assert any(p.endswith("a.txt") for p in listing)
    assert fs.listdir_with_metafile(d) == listing
    assert os.path.exists(os.path.join(d, ".listing.pkl"))
    assert fs.listdir_with_metafile(d) == listing                 # the cached listing
    fs.copy(os.path.join(d, "a.txt"), str(tmp_path / "b.txt"))
    assert fs.exists(str(tmp_path / "b.txt"))
    fs.copy(d, str(tmp_path / "y"))
    assert fs.exists(str(tmp_path / "y" / "a.txt"))
    fs.remove(str(tmp_path / "b.txt"))
    fs.remove(str(tmp_path / "y"))
    assert not fs.exists(str(tmp_path / "b.txt")) and not fs.exists(str(tmp_path / "y"))
    assert not fs.is_hdfs_path(d) and fs.is_hdfs_path("hdfs://cluster/path")
    assert fs.download(d) == d


def test_init_distributed(tmp_path):
    """Two spawned ranks over gloo (a file store under tmp_path): each gets
    (rank, 2), a second call in the started group returns the same, a call
    for the card's backend (NCCL) in that gloo group raises, and one for
    the card with the gloo override returns the group."""
    from tests.test_torch_parallel import init_task, spawn

    results = spawn(init_task, 2, tmp_path)
    assert [r["init"] for r in results] == [(0, 2), (1, 2)]
    assert [r["again"] for r in results] == [(0, 2), (1, 2)]
    assert all("takes nccl" in r["other_backend"] for r in results)
    assert [r["gloo_on_card"] for r in results] == [(0, 2), (1, 2)]


def test_scalar_writer_jsonl(tmp_path, monkeypatch):
    """Without tensorboard the writer keeps the JAX module's JSONL; on a
    rank other than 0 it writes nothing."""
    from bitdance_tpu_torch.utils.logging import ScalarWriter

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    w = ScalarWriter(str(tmp_path / "tb"))
    w.add_scalar("train/loss", torch.tensor(1.5), 3)
    w.add_scalar("train/lr", 0.25, 4)
    w.close()
    rows = [json.loads(x) for x in (tmp_path / "tb" / "scalars.jsonl").read_text().splitlines()]
    assert [(r["tag"], r["value"], r["step"]) for r in rows] == [
        ("train/loss", 1.5, 3), ("train/lr", 0.25, 4)]
    other = ScalarWriter(str(tmp_path / "tb1"), rank=1)
    other.add_scalar("x", 1.0, 1)
    other.close()
    assert not (tmp_path / "tb1").exists()


def test_metric_accumulator_reads_once_per_flush(monkeypatch):
    from bitdance_tpu_torch.utils.logging import MetricAccumulator

    reads = []
    real = torch.Tensor.tolist
    monkeypatch.setattr(torch.Tensor, "tolist", lambda self: reads.append(1) or real(self))
    acc = MetricAccumulator()
    for i in range(4):
        acc.update(loss=torch.tensor(float(i)), grad_norm=torch.tensor(2.0 * i), n=1)
    assert not reads
    means, sps = acc.flush()
    assert len(reads) == 1 and sps > 0
    assert means == {"loss": 1.5, "grad_norm": 3.0, "n": 1.0}
    assert acc.count == 0 and acc.flush()[0] == {}


def test_logger_writes_log_txt(tmp_path):
    from bitdance_tpu_torch.utils.logging import create_logger

    for name in ("a", "b"):
        create_logger(str(tmp_path / name)).info(f"hello {name}")
    for name in ("a", "b"):
        assert f"hello {name}" in (tmp_path / name / "log.txt").read_text()
    assert "hello b" not in (tmp_path / "a" / "log.txt").read_text()


def test_step_profiler_writes_its_trace(tmp_path):
    from bitdance_tpu_torch.utils.profiler import (
        StepProfiler,
        annotate,
        enable_nan_debugging,
        trace,
    )

    prof = StepProfiler(str(tmp_path), wait=2, warmup=1, active=2)
    x = torch.randn(64, 64)
    for _ in range(7):
        with annotate("matmul_step"):
            x = torch.tanh(x @ x)
        prof.step()
    prof.close()
    files = sorted(os.listdir(tmp_path / "host_0"))
    assert files == ["trace_step4.json"], files
    assert "matmul_step" in (tmp_path / "host_0" / files[0]).read_text()
    off = StepProfiler(str(tmp_path / "off"), wait=0, active=1, enabled=False)
    off.step()
    off.close()
    assert not (tmp_path / "off").exists()
    with trace(str(tmp_path / "one")):
        torch.ones(3).sum()
    assert (tmp_path / "one" / "trace.json").exists()
    enable_nan_debugging(True)
    assert torch.is_anomaly_enabled()
    enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()
