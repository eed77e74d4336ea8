"""The port's data parallelism on the CPU over gloo (bitdance_tpu_torch/
parallel, the sharded train steps, sharded checkpoints, the commands at
world 2), against the JAX package and against the port's unsharded steps.

Ranks are spawned processes that start their group from a file store under
the test's temporary directory (no port to collide between pytest workers)
and must finish within SPAWN_TIMEOUT_S, so a hung rank fails the test. One
world-2 group (replica 1, fsdp 2) runs every world-2 check in one spawn and
hands its results back through files; the tests read them:
  - init_distributed returns (rank, 2) on each rank, and the mesh's shape
    rules;
  - the sharded ImageNet step against the unsharded ``train_step`` on the
    same global batch and seed: 3 steps, bf16 mixed precision and fp32;
  - the world-2 ImageNet step against JAX's ``make_sharded_train_step`` on
    two CPU devices, one fp32 step under shape-keyed noise tables;
  - a world-2 checkpoint resumed at world 2 ends bit-equal to the straight
    run, and the same directory restored at world 1 equals the gathered
    state;
  - cli.train_imagenet and cli.train_mllm take 2 steps at world 2.
The (replica 2, fsdp 2) group is in tests/test_torch_parallel_hsdp.py.
"""

import os
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from bitdance_tpu_torch.models import imagenet_ar as tia
from bitdance_tpu_torch.parallel import mesh as tmesh
from bitdance_tpu_torch.train import imagenet_train as tit
from bitdance_tpu_torch.train.checkpoints import CheckpointManager, state_tensors
from bitdance_tpu_torch.utils.dtensor import local

SPAWN_TIMEOUT_S = 300

TINY = dict(dim=64, n_layer=2, n_head=2, diff_layers=2, diff_dim=64,
            diff_adanln_layers=1, latent_dim=8, down_size=16, patch_size=1,
            resolution=64, cls_token_num=4, num_classes=10, diff_batch_mul=2,
            perturb_rate=0.1)


# ---------------------------------------------------------------------------
# spawning a CPU world
# ---------------------------------------------------------------------------

def spawn(task, world: int, workdir, **kw) -> list[dict]:
    """Run ``task(rank, world, workdir, **kw)`` (a module-level function) in
    ``world`` processes joined by a gloo group; returns each rank's dict.
    A rank that raises, or a group that outlives SPAWN_TIMEOUT_S, fails."""
    workdir = str(workdir)
    ctx = mp.start_processes(_worker, args=(world, workdir, task, kw), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{task.__name__}: world {world} ran past "
                                   f"{SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(os.path.join(workdir, f"{task.__name__}.{r}.pt"),
                       weights_only=False) for r in range(world)]


def _worker(rank, world, workdir, task, kw):
    from bitdance_tpu_torch.utils.fs import init_distributed

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    got = init_distributed("cpu", init_method=f"file://{workdir}/store")
    try:
        out = {"init": got, **task(rank, world, workdir, **kw)}
        torch.save(out, os.path.join(workdir, f"{task.__name__}.{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

class Draws:
    """Deterministic tables keyed by (kind, shape, k): the k-th draw of a
    kind and shape on one side equals the k-th on the other (as
    tests/test_torch_imagenet_train.py draws them)."""

    def __init__(self):
        self.counts = {"jax": {}, "torch": {}}

    def __call__(self, side, kind, shape):
        shape = tuple(int(s) for s in shape)
        k = self.counts[side].get((kind, shape), 0)
        self.counts[side][(kind, shape)] = k + 1
        seed = 5 + 7919 * k + (104729 if kind == "uniform" else 0)
        for d in shape:
            seed = (seed * 131 + d + 7) % (2 ** 31 - 1)
        rng = np.random.default_rng(seed)
        if kind == "normal":
            return rng.standard_normal(shape).astype(np.float32)
        return rng.random(shape).astype(np.float32)

    def patch_torch(self):
        """Replace torch.randn / torch.rand; returns the undo."""
        saved = torch.randn, torch.rand
        torch.randn = lambda shape, generator=None, device=None: \
            torch.from_numpy(self("torch", "normal", shape)).to(device)
        torch.rand = lambda shape, generator=None, device=None: \
            torch.from_numpy(self("torch", "uniform", shape)).to(device)

        def undo():
            torch.randn, torch.rand = saved
        return undo


def imagenet_state(tcfg, seed=0, noise=0.05):
    """An fp32 TINY ImageNet train state, every weight moved by N(0, noise)
    so that the zero adaLN / final layers give the backbone a gradient."""
    cfg = tia.ImageNetARConfig(**TINY)
    g = torch.Generator().manual_seed(seed)
    model = tit.ImageNetTrainModel(cfg)
    tia.init_ar_params(model.ar, g)
    tit.init_head_params(model.head, g)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(noise * torch.randn(p.shape, generator=g))
    return tit.make_train_state(model, tcfg)


def imagenet_batch(b, seed):
    cfg = tia.ImageNetARConfig(**TINY)
    g = torch.Generator().manual_seed(seed)
    tokens = torch.sign(torch.randn((b, cfg.num_tokens, cfg.token_dim), generator=g))
    cls = torch.randint(0, cfg.num_classes, (b,), generator=g)
    return tokens, cls


def imagenet_vs_unsharded(mesh, mixed, steps=3, b=8):
    """The sharded step and ``train_step`` from one state over ``steps``
    global batches with one generator seed each (warmup 1: the first step
    has lr 0): per step (loss, loss, grad norm, grad norm); the parameters
    before, and {name: (sharded, unsharded)} of the parameters after the
    first and the last step and of the EMA after the last; and how many
    parameters are really split (a shard smaller than the tensor)."""
    tcfg = tit.ImageNetTrainConfig(lr=1e-3, warmup_steps=1, weight_decay=0.05,
                                   ema_decay=0.9, mixed_precision=mixed)
    ref = imagenet_state(tcfg)
    before = {n: p.detach().clone() for n, p in ref.model.named_parameters()}
    fn, st = tit.make_sharded_train_step(mesh, imagenet_state(tcfg),
                                         ref.model.cfg, tcfg)
    ref_p = dict(ref.model.named_parameters())
    rows = tmesh.batch_rows(mesh, b)
    out = {"metrics": [], "before": before}
    for s in range(steps):
        tokens, cls = imagenet_batch(b, 10 + s)
        mr = tit.train_step(ref, tokens, cls, torch.Generator().manual_seed(100 + s),
                            ema_decay=tcfg.ema_decay, mixed_precision=mixed)
        ms = fn(st, tokens[rows], cls[rows], torch.Generator().manual_seed(100 + s))
        out["metrics"].append([float(mr["loss"]), float(ms["loss"]),
                               float(mr["grad_norm"]), float(ms["grad_norm"])])
        if s in (0, steps - 1):
            out["first" if s == 0 else "last"] = {
                n: (p.full_tensor().detach(), ref_p[n].detach().clone())
                for n, p in st.model.named_parameters()}
    out["ema"] = {n: (e.full_tensor(), ref.ema[n]) for n, e in st.ema.items()}
    out["split"] = sum(local(p).numel() < p.numel() for p in st.model.parameters())
    out["step"], out["count"] = st.step, st.tx.count
    return out


def assert_imagenet_close(r, mixed, lr=1e-3):
    """fp32: every step's loss and grad norm within 1e-5 relative, the
    parameters and the EMA within 1e-6 (+ 1e-5 relative).

    bf16 mixed precision: JAX's own tolerances (tests/test_sharding.py:
    80-86, one step under warmup) on the first step: loss and grad norm
    1e-4 relative, parameters rtol 2e-3 / atol 2e-4. Once parameters move,
    the shards' bf16 gradients, summed in another order than one process's,
    move a master across a bf16 rounding or flip an Adam move where the
    gradient is near 0 (as tests/test_torch_imagenet_train.py's bf16 step
    against JAX): the last loss within 1e-3, 99% of the moves within 0.1 lr
    and every one within 2 lr."""
    m = np.asarray(r["metrics"])
    rtol = 1e-4 if mixed else 1e-5
    n_exact = 1 if mixed else len(m)
    np.testing.assert_allclose(m[:n_exact, 1], m[:n_exact, 0], rtol=rtol)
    np.testing.assert_allclose(m[:n_exact, 3], m[:n_exact, 2], rtol=rtol)
    np.testing.assert_allclose(m[:, 1], m[:, 0], rtol=1e-3)
    for n, (got, want) in r["first"].items():
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3 if mixed else 1e-5,
                                   atol=2e-4 if mixed else 1e-6, err_msg=n)
    moves = [((got - r["before"][n]).flatten(), (want - r["before"][n]).flatten())
             for n, (got, want) in r["last"].items()]
    mt, mr = torch.cat([a for a, _ in moves]), torch.cat([b for _, b in moves])
    lr_sum = lr * (len(m) - 1)
    assert mr.abs().max() > 0.5 * lr_sum                  # the steps trained
    diff = (mt - mr).abs() / lr
    if mixed:
        assert (diff < 0.1).float().mean() > 0.99 and diff.max() < 2
    else:
        assert diff.max() < 1e-3
        for n, (got, want) in r["ema"].items():
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=n)
    assert r["split"] > 0
    assert r["step"] == r["count"] == len(m)


# ---------------------------------------------------------------------------
# the world-2 group
# ---------------------------------------------------------------------------

MLLM_YAML = {
    "model": {
        "vit_patch_size": 16,
        "encoder": {"params": {"ddconfig": {"z_channels": 8}}},
        "llm": {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
                "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16},
        "head": {"vision_pred": {"model_dim": 128, "num_blocks": 2, "num_adaln": 2,
                                 "parallel_num": 4, "P_mean": -0.8, "P_std": 0.8,
                                 "use_swiglu": True},
                 "vision_perturb": 0.1, "pe_max_len": 64},
    },
    "data": {"max_num_tokens_per_sample": 0},
    "training": {"global_seed": 7, "auto_resume": True, "log_every": 1,
                 "save_every": 2, "validate_every": 0, "warmup_steps": 1,
                 "lr": 1e-3, "min_lr": 0.0, "beta1": 0.9, "beta2": 0.95, "eps": 1e-15,
                 "max_grad_norm": 1.0, "loss_weight_text": 0.01,
                 "loss_weight_vision": 1.0, "num_replicate": 1, "num_shard": 2},
}
SMALL_TOKENIZER = dict(in_channels=3, out_ch=3, ch=32, ch_mult=[1, 1, 1, 1, 1],
                       num_res_blocks=1)


def _inputs(root):
    """The commands' data: an image folder (4 classes x 4 images) and 5
    packed .npz sequences."""
    from PIL import Image

    from bitdance_tpu_torch.data import packing as tpack

    rng = np.random.default_rng(0)
    for c in range(4):
        d = root / "imgs" / f"class_{c}"
        d.mkdir(parents=True)
        for i in range(4):
            Image.fromarray(rng.integers(0, 255, (40 + 5 * c, 48 + 3 * i, 3),
                                         np.uint8)).save(d / f"img_{i}.png")
    table = tpack.sincos_1d_table_np(32, 64)
    (root / "packed").mkdir()
    for f in range(5):
        samples = [tpack.T2ISample(
            text_ids=rng.integers(1, 250, int(rng.integers(5, 12))),
            image_latents=np.sign(rng.normal(size=(16, 8))).astype(np.float32),
            latent_h=4, latent_w=4, vision_start_id=251, res_h_id=252, res_w_id=253,
            query_ids=np.arange(260, 263), text_loss=True) for _ in range(2)]
        raw = tpack.pack_t2i_batch(samples, 4, 128, table, text_budget=48, vis_budget=48)
        np.savez(root / "packed" / f"{f:03d}.npz", **raw)
    import yaml

    (root / "mllm.yaml").write_text(yaml.safe_dump(MLLM_YAML))


def world2_task(rank, world, workdir):
    from bitdance_tpu_torch.cli import common, train_imagenet, train_mllm
    from bitdance_tpu_torch.io.from_jax import load_into

    out = {}
    mesh = tmesh.create_mesh(device_type="cpu")
    out["mesh"] = tuple(mesh.shape)
    out["rows"] = tmesh.batch_rows(mesh, 8)
    try:
        tmesh.create_mesh(device_type="cpu", replica=1, fsdp=1)
        out["raised {'replica': 1, 'fsdp': 1}"] = None
    except ValueError as e:
        out["raised {'replica': 1, 'fsdp': 1}"] = str(e)
    # a tensor-parallel mesh builds (ROADMAP A11b): tp 2 over both ranks
    tp_mesh = tmesh.create_mesh(device_type="cpu", tp=2)
    tp = tmesh.tp_group(tp_mesh)
    out["tp_mesh"] = (tuple(tp_mesh.shape), tp.rank, tp.size,
                      dist.get_world_size(tp.group))

    out["imagenet_mixed"] = imagenet_vs_unsharded(mesh, True)
    out["imagenet_fp32"] = imagenet_vs_unsharded(mesh, False)

    # one fp32 step from the JAX package's weights under shape-keyed draws
    tcfg = tit.ImageNetTrainConfig(lr=1e-3, warmup_steps=0, weight_decay=0.05,
                                   ema_decay=0.9, mixed_precision=False)
    init = torch.load(os.path.join(workdir, "jax_init.pt"), weights_only=False)
    model = load_into(tit.ImageNetTrainModel(tia.ImageNetARConfig(**TINY)), init["sd"])
    fn, st = tit.make_sharded_train_step(mesh, tit.make_train_state(model, tcfg),
                                         model.cfg, tcfg)
    rows = tmesh.batch_rows(mesh, init["tokens"].shape[0])
    undo = Draws().patch_torch()
    try:
        m = fn(st, init["tokens"][rows], init["cls"][rows])
    finally:
        undo()
    out["jax_step"] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                       "params": {n: p.full_tensor() for n, p in st.model.named_parameters()},
                       "ema": {n: e.full_tensor() for n, e in st.ema.items()}}

    # checkpoints: 4 steps straight (saves at 2 and 4) against 2 restored + 2
    tcfg = tit.ImageNetTrainConfig(lr=1e-3, warmup_steps=1, ema_decay=0.9)
    ck_dir = os.path.join(workdir, "ck")
    runs = []
    for restore in (False, True):
        fn, st = tit.make_sharded_train_step(mesh, imagenet_state(tcfg),
                                             tia.ImageNetARConfig(**TINY), tcfg)
        ck = CheckpointManager(ck_dir, keep_last_n=0)
        first = 0
        if restore:
            _, first, ds = ck.restore(st, step=2, with_data_status=True)
            out["restored_data_status"] = ds
        for s in range(first, 4):
            tokens, cls = imagenet_batch(8, 20 + s)
            rows = tmesh.batch_rows(mesh, 8)
            fn(st, tokens[rows], cls[rows], torch.Generator().manual_seed(200 + s))
            if not restore and s + 1 in (2, 4):
                ck.save(s + 1, st, data_status={"step": s + 1})
        ck.close()
        runs.append(st)
    a, b = state_tensors(runs[0]), state_tensors(runs[1])
    out["ckpt_names_equal"] = set(a) == set(b)
    out["ckpt_differ"] = [k for k in a
                          if not torch.equal(local(a[k]), local(b[k]))]
    out["ckpt_gathered"] = {k: v.full_tensor() if hasattr(v, "full_tensor") else v
                            for k, v in a.items()}
    out["ckpt_files"] = sorted(os.listdir(os.path.join(ck_dir, "4")))
    ck = CheckpointManager(os.path.join(workdir, "ck_async"), async_save=True)
    try:
        ck.save(4, runs[0])
        out["async_refused"] = None
    except ValueError as e:
        out["async_refused"] = str(e)
    ck.close()

    # both commands, 2 steps each; their scalars go to JSONL (importing
    # tensorboard pulls in TensorFlow here, ~12 s a process)
    sys.modules["torch.utils.tensorboard"] = None
    root = workdir
    common.TOKENIZER_DDCONFIG = SMALL_TOKENIZER
    stats = {}
    train_imagenet.main(["--data-path", os.path.join(root, "imgs"), "--model", "BitDance-S",
                         "--global-batch-size", "4", "--epochs", "2", "--warmup-steps", "1",
                         "--log-every", "1", "--diff-batch-mul", "2", "--max-steps", "2",
                         "--results-dir", os.path.join(root, "cli_imagenet"),
                         "--device", "cpu"], stats=stats)
    out["cli_imagenet"] = {"steps": len(stats["step_seconds"]),
                           "files": sorted(os.listdir(os.path.join(
                               root, "cli_imagenet", "checkpoints", "2")))}
    stats = {}
    train_mllm.main(["--config", os.path.join(root, "mllm.yaml"), "--data-dir",
                     os.path.join(root, "packed"), "--vocab-size", "300",
                     "--max-steps", "2", "--results-dir", os.path.join(root, "cli_mllm"),
                     "--device", "cpu"], stats=stats)
    with open(os.path.join(root, "cli_mllm", "checkpoints", "2", "data_status.json")) as f:
        ds = f.read()
    out["cli_mllm"] = {"steps": len(stats["step_seconds"]), "mesh": stats["mesh"],
                       "data_status": ds}
    return out


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Inputs written, then the world-2 group; (results by rank, workdir,
    the JAX side's inputs)."""
    import jax
    import jax.numpy as jnp

    from bitdance_tpu.models import imagenet_ar as jia
    from bitdance_tpu_torch.io.from_jax import imagenet_train_state_from_jax

    root = tmp_path_factory.mktemp("world2")
    _inputs(root)
    jcfg = jia.ImageNetARConfig(**TINY)
    head = jia.make_head(jcfg)
    params = {"ar": jia.init_ar_params(jax.random.PRNGKey(4), jcfg),
              "head": head.init(jax.random.PRNGKey(5), jnp.zeros((2, jcfg.token_dim)),
                                jnp.zeros((2, jcfg.dim)), jax.random.PRNGKey(0))}
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda l: jnp.asarray(np.asarray(l) + 0.05 * rng.standard_normal(l.shape),
                              jnp.float32), params)
    tokens, cls = imagenet_batch(4, 3)
    sd = {k: np.asarray(v) for k, v in imagenet_train_state_from_jax(params).items()}
    torch.save({"sd": sd, "tokens": tokens, "cls": cls}, root / "jax_init.pt")
    results = spawn(world2_task, 2, root)
    return results, root, (jcfg, head, params, tokens, cls)


def test_init_distributed_and_mesh_at_world_2(world2):
    results, _, _ = world2
    assert [r["init"] for r in results] == [(0, 2), (1, 2)]
    assert all(r["mesh"] == (1, 2, 1) for r in results)
    assert [r["rows"] for r in results] == [slice(0, 4), slice(4, 8)]
    r = results[0]
    assert "1x1x1 != 2" in r["raised {'replica': 1, 'fsdp': 1}"]
    assert [r["tp_mesh"] for r in results] == [((1, 1, 2), 0, 2, 2), ((1, 1, 2), 1, 2, 2)]


@pytest.mark.parametrize("mixed", [True, False], ids=["bf16_mixed", "fp32"])
def test_sharded_imagenet_step_equals_unsharded_at_1x2(world2, mixed):
    results, _, _ = world2
    r = results[0]["imagenet_mixed" if mixed else "imagenet_fp32"]
    assert_imagenet_close(r, mixed)
    # the other rank reports the same whole tensors
    other = results[1]["imagenet_mixed" if mixed else "imagenet_fp32"]
    for n, (got, _) in r["last"].items():
        assert torch.equal(got, other["last"][n][0]), n


def test_world_2_imagenet_step_equals_jax_sharded_step(world2, monkeypatch):
    """One fp32 step on JAX's make_sharded_train_step over a (1, 2) mesh of
    CPU devices against the port's world-2 step, under the same
    shape-keyed draws: loss and grad norm relative 1e-5; parameter moves
    within the criteria of tests/test_torch_imagenet_train.py's fp32 step
    (all within 0.05 lr, at most 0.1% beyond 1e-3 lr); the EMA within 1e-6
    plus (1 - decay) x 0.05 lr."""
    import jax
    import jax.numpy as jnp
    import optax

    from bitdance_tpu.parallel.mesh import create_mesh
    from bitdance_tpu.train import imagenet_train as jit_
    from bitdance_tpu.train import optim as jopt
    from bitdance_tpu_torch.io.from_jax import imagenet_train_state_from_jax

    results, _, (jcfg, head, params, tokens, cls) = world2
    draws = Draws()
    monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32:
                        jnp.asarray(draws("jax", "normal", shape), dtype))
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape=(), dtype=jnp.float32,
                        minval=0.0, maxval=1.0:
                        jnp.asarray(draws("jax", "uniform", shape), dtype))
    lr = 1e-3
    tc = jit_.ImageNetTrainConfig(lr=lr, warmup_steps=0, weight_decay=0.05,
                                  ema_decay=0.9, mixed_precision=False)
    # the port's decay mask: JAX's without the stacked RMSNorm gains (C4)
    sched = jopt.make_lr_schedule(tc.lr, tc.warmup_steps, tc.total_steps,
                                  tc.decay_start, tc.min_lr)
    mask = jopt.decay_mask(params, jit_.NON_DECAY_KEYS)
    for k in ("attention_norm", "ffn_norm"):
        mask["ar"]["layers"][k] = False
    tx = optax.chain(optax.clip_by_global_norm(tc.max_grad_norm),
                     optax.adamw(sched, b1=tc.betas[0], b2=tc.betas[1], eps=tc.eps,
                                 weight_decay=tc.weight_decay, mask=mask))
    before = imagenet_train_state_from_jax(params)      # the step donates its state
    jstate = jopt.TrainState.create(params, tx)
    mesh = create_mesh(replica=1, fsdp=2, devices=jax.devices()[:2])
    step_fn, state_sh = jit_.make_sharded_train_step(mesh, jstate, jcfg, head, tx, tc)
    jstate, jm = step_fn(jax.device_put(jstate, state_sh), jnp.asarray(tokens.numpy()),
                         jnp.asarray(cls.numpy(), jnp.int32), jax.random.PRNGKey(0))
    got = results[0]["jax_step"]
    np.testing.assert_allclose(got["loss"], float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], float(jm["grad_norm"]), rtol=1e-5)
    want = imagenet_train_state_from_jax(jax.device_get(jstate.params))
    want_ema = imagenet_train_state_from_jax(jax.device_get(jstate.ema_params))
    mt = torch.cat([(got["params"][n] - torch.from_numpy(np.array(before[n]))).flatten()
                    for n in got["params"]])
    mj = torch.cat([torch.from_numpy(np.asarray(want[n]) - np.asarray(before[n])).flatten()
                    for n in got["params"]])
    assert mj.abs().max() > 0.5 * lr
    diff = (mt - mj).abs() / lr
    assert (diff > 1e-3).float().mean() < 1e-3 and diff.max() < 0.05
    for n, e in got["ema"].items():
        np.testing.assert_allclose(e.numpy(), np.asarray(want_ema[n]), rtol=0,
                                   atol=1e-6 + 0.1 * 0.05 * lr, err_msg=n)


def test_world_2_checkpoint_resumes_bit_equal(world2):
    results, _, _ = world2
    for r in results:
        assert r["ckpt_names_equal"] and r["ckpt_differ"] == []
        assert r["restored_data_status"] == {"step": 2}
    assert results[0]["ckpt_files"] == [
        "data_status.json", "meta.json", "shards.rank00000.json", "shards.rank00001.json",
        "state.rank00000-of-00002.safetensors", "state.rank00001-of-00002.safetensors"]
    # an asynchronous save of a sharded state is refused on every rank
    assert all("async_save" in r["async_refused"] for r in results)


def test_world_2_checkpoint_restores_at_world_1(world2):
    """The step-4 directory written by two ranks, restored into an unsharded
    state in this process, equals the state the ranks gathered."""
    results, root, _ = world2
    tcfg = tit.ImageNetTrainConfig(lr=1e-3, warmup_steps=1, ema_decay=0.9)
    state = imagenet_state(tcfg, seed=9)
    ck = CheckpointManager(os.path.join(root, "ck"))
    _, step, _ = ck.restore(state, step=4)
    ck.close()
    assert step == 4 and state.step == 4 and state.tx.count == 4
    got = state_tensors(state)
    want = results[0]["ckpt_gathered"]
    assert set(got) == set(want)
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    assert not differ, differ[:8]


def test_commands_train_at_world_2(world2):
    results, root, _ = world2
    for r in results:
        assert r["cli_imagenet"]["steps"] == 2 and r["cli_mllm"]["steps"] == 2
        assert r["cli_mllm"]["mesh"] == (1, 2)
    assert "state.rank00001-of-00002.safetensors" in results[0]["cli_imagenet"]["files"]
    # 2 steps x 2 data shards x 1 sequence
    assert results[0]["cli_mllm"]["data_status"] == '{"file": 4}'
    assert (root / "cli_mllm" / "log.txt").exists()


# ---------------------------------------------------------------------------
# the FSDP rule against JAX's
# ---------------------------------------------------------------------------

def _spec(p):
    return tuple(p)


def test_fsdp_partition_spec_cases_match_jax():
    """The cases of tests/test_sharding.py:42-52, and the rule's edges."""
    from bitdance_tpu.parallel.mesh import fsdp_partition_spec as jspec

    cases = [("['norm']", (64,), 8), ("['embed']", (1001, 512), 8),
             ("['embed']", (1024, 512), 8), ("['layers']['wqkv']", (40, 512, 1536), 8),
             ("['x']", (999, 333), 8), ("['layers']['norm']", (40, 5120), 8),
             ("['w']", (4096, 4096), 1), ("['w']", (128, 128), 2),
             ("['w']", (127, 129), 2), ("['layers']['x']", (64,), 1)]
    for path, shape, n in cases:
        assert tmesh.fsdp_partition_spec(path, shape, n) == _spec(jspec(path, shape, n)), \
            (path, shape, n)
    assert tmesh.fsdp_partition_spec("['embed']", (1001, 512), 8) == (None, "fsdp")
    assert tmesh.fsdp_partition_spec("['norm']", (64,), 8) == ()


@pytest.mark.parametrize("fsdp", [2, 4, 8])
def test_fsdp_partition_spec_matches_jax_on_the_tiny_trees(fsdp):
    """Every (path, shape) leaf of JAX's tiny ImageNet train tree
    (tests/test_sharding.py:_tiny_cfg, parallel 4) and of its tiny MLLM tree
    (tests/test_mllm.py:_tiny_cfg)."""
    import jax

    from bitdance_tpu.models import mllm as jm
    from bitdance_tpu.parallel.mesh import fsdp_partition_spec as jspec
    from bitdance_tpu.train import imagenet_train as jit_
    from tests.test_mllm import _tiny_cfg as mllm_tiny
    from tests.test_sharding import _tiny_cfg as imagenet_tiny

    state, _, _ = jit_.init_train_state(jax.random.PRNGKey(0), imagenet_tiny(4),
                                        jit_.ImageNetTrainConfig())
    mparams = jax.eval_shape(lambda: jm.init_mllm_params(jax.random.PRNGKey(0),
                                                         mllm_tiny()))
    leaves = (jax.tree_util.tree_leaves_with_path(state.params)
              + jax.tree_util.tree_leaves_with_path(mparams))
    assert len(leaves) > 40
    split = 0
    for path, leaf in leaves:
        p = jax.tree_util.keystr(path)
        want = _spec(jspec(p, leaf.shape, fsdp))
        assert tmesh.fsdp_partition_spec(p, leaf.shape, fsdp) == want, (p, leaf.shape)
        split += want != ()
    assert split > 0


def test_shard_dim_is_the_port_mapping():
    """The port's tensors carry no layer axis: [out, in] weights take the
    rule with every axis open, the largest divisible one first."""
    assert tmesh.shard_dim((512, 64), 2) == 0
    assert tmesh.shard_dim((64, 512), 2) == 1
    assert tmesh.shard_dim((11, 256), 2) is None         # under 2**14 elements
    assert tmesh.shard_dim((4097, 4096), 2) == 1
    assert tmesh.shard_dim((4096, 4096), 1) is None


def init_task(rank, world, workdir):
    """init_distributed again in a started group returns the same; asked
    for the card's backend in the started gloo group, it raises, and with
    the gloo override for the card (ranks sharing one card) it returns the
    group. It ran no collective after its group started: the group's start
    holds every rank until all are connected (ROADMAP C13)."""
    from bitdance_tpu_torch.utils.fs import init_distributed

    try:
        init_distributed("cuda")
        other = None
    except RuntimeError as e:
        other = str(e)
    return {"again": init_distributed("cpu"), "other_backend": other,
            "gloo_on_card": init_distributed("cuda", backend="gloo", device_index=0)}


def test_init_distributed_refuses_a_world_that_does_not_start(tmp_path):
    """WORLD_SIZE 2 whose rendezvous fails (no MASTER_ADDR) raises in a
    fresh process; no group of one is started in its place."""
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if not k.startswith("MASTER_")}
    env.update(RANK="1", WORLD_SIZE="2")
    code = ("import torch.distributed as dist\n"
            "from bitdance_tpu_torch.utils.fs import init_distributed\n"
            "try:\n"
            "    init_distributed('cpu')\n"
            "except RuntimeError as e:\n"
            "    assert 'did not start' in str(e), e\n"
            "    assert not dist.is_initialized()\n"
            "    print('refused')\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=os.getcwd(),
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "refused", out.stderr[-2000:]
