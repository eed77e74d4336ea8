"""The port's training-run proof (bitdance_tpu_torch/cli/train_proof.py)
on the CPU, against scripts/train_proof.py of the JAX package.

The real orchestration at tests/test_train_proof.py's smoke size
(BitDance-S, batch 8, 6 steps, a kill at 4, a checkpoint every 2, descent
not required): the parent starts the run phase, which saves and dies with
os._exit(9), then the resume phase, which restores, checks the sha256 digest
taken at save time and trains on. Checked: the JSONL's event sequence and
each line's keys are the JAX script's (read from its source, not run: it
takes ~50 s on the CPU), steps 1..6 with no gap or repeat, one bit-identical
resume at step 4, the run phase's return code 9, the final digest equal to a
straight 6-step run's, and the synthetic batches equal to the JAX script's
bit for bit. Once more at world 2 over gloo: the sharded save -> kill ->
restore that the JAX test covers on 8 virtual devices.
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from bitdance_tpu_torch.cli import train_proof as tproof

REPO = Path(__file__).resolve().parents[1]
SMOKE = ["--model", "BitDance-S", "--batch", "8", "--steps", "6", "--ckpt-every", "2",
         "--warmup", "2", "--device", "cpu", "--no-require-descent"]
# scripts/train_proof.py's log at this size: start, steps 1-2, save 2, steps
# 3-4, save 4 (then the kill), resume, steps 5-6, save 6, done
EVENTS = ["start", None, None, "save", None, None, "save", "resume", None, None, "save",
          "done"]
TIMEOUT_S = 400


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_train_proof",
                                                  REPO / "scripts" / "train_proof.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_line_keys() -> dict:
    """{event, or "step" for a step's line: keys} of every log line the JAX
    script builds (its dict literals with an "event" or a "loss" key)."""
    tree = ast.parse((REPO / "scripts" / "train_proof.py").read_text())
    out = {}
    for d in ast.walk(tree):
        if not isinstance(d, ast.Dict):
            continue
        keys = [getattr(k, "value", None) for k in d.keys]
        if "event" in keys:
            out[d.values[keys.index("event")].value] = keys
        elif "loss" in keys:
            out["step"] = keys
    return out


def _run(args, out: Path, wd: Path, **popen):
    cmd = [sys.executable, "-m", "bitdance_tpu_torch.cli.train_proof", *SMOKE, *args,
           "--out", str(out), "--workdir", str(wd)]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, **popen)


def _finish(p) -> tuple[int, str]:
    text, _ = p.communicate(timeout=TIMEOUT_S)
    return p.returncode, text


def _lines(path: Path) -> list[dict]:
    return [json.loads(ln) for ln in path.read_text().splitlines()]


@pytest.fixture(scope="module")
def proofs(tmp_path_factory):
    """The proof at world 1 (its run phase's return code read from a run
    phase alone too), a straight 6-step run, and the proof at world 2."""
    root = tmp_path_factory.mktemp("proof")
    straight = _run(["--phase", "run", "--kill-at", "0"], root / "straight.jsonl",
                    root / "straight")
    proof = _run(["--kill-at", "4"], root / "w1.jsonl", root / "w1")
    got = {"w1": _finish(proof), "straight": _finish(straight)}
    killed = _run(["--phase", "run", "--kill-at", "4"], root / "killed.jsonl", root / "killed")
    got["w2"] = _finish(_run(["--kill-at", "4", "--world", "2"], root / "w2.jsonl",
                             root / "w2"))
    got["killed"] = _finish(killed)
    for k in ("w1", "w2", "straight", "killed"):
        got[k] = (*got[k], _lines(root / f"{k}.jsonl"))
    got["ckpt_w2"] = sorted(os.listdir(root / "w2" / "checkpoints" / "6"))
    return got


@pytest.mark.parametrize("world", ["w1", "w2"])
def test_kill_resume_roundtrip(proofs, world):
    """tests/test_train_proof.py's checks, at world 1 and 2: TRAIN_PROOF OK,
    one resume at step 4 bit-identical, steps 1..6 with no gap or repeat."""
    rc, text, lines = proofs[world]
    assert rc == 0, text[-3000:]
    assert "TRAIN_PROOF OK" in text
    resume = [e for e in lines if e.get("event") == "resume"]
    assert len(resume) == 1 and resume[0]["step"] == 4
    assert resume[0]["bit_identical"] is True
    assert resume[0]["digest"] == resume[0]["digest_at_save"]
    assert [e["step"] for e in lines if "loss" in e] == [1, 2, 3, 4, 5, 6]
    assert lines[-1]["event"] == "done" and lines[-1]["steps"] == 6


@pytest.mark.parametrize("world", ["w1", "w2"])
def test_log_matches_the_jax_scripts(proofs, world):
    """The port's JSONL: the JAX script's event sequence, and each line the
    keys of the JAX line of its kind, in its order."""
    lines = proofs[world][2]
    assert [e.get("event") for e in lines] == EVENTS
    want = _jax_line_keys()
    assert set(want) == {"resume", "start", "step", "save", "done"}
    for e in lines:
        assert list(e) == want[e.get("event", "step")], e


def test_run_phase_dies_with_9_after_its_save(proofs):
    rc, text, lines = proofs["killed"]
    assert rc == 9, text[-3000:]
    assert "KILL at step 4" in text
    assert lines[-1] == {"event": "save", "step": 4, "digest": lines[-1]["digest"]}
    assert [e["step"] for e in lines if "loss" in e] == [1, 2, 3, 4]


def test_resumed_run_ends_where_a_straight_run_ends(proofs):
    """The killed-and-resumed run's last digest (step 6) equals a straight
    run's; so do the digests both runs took at steps 2 and 4."""
    rc, text, straight = proofs["straight"]
    assert rc == 0, text[-3000:]

    def saves(lines):
        return {e["step"]: e["digest"] for e in lines if e.get("event") == "save"}

    assert saves(straight) == saves(proofs["w1"][2])
    assert saves(proofs["killed"][2]) == {k: v for k, v in saves(straight).items() if k <= 4}
    assert [e["loss"] for e in straight if "loss" in e] == \
        [e["loss"] for e in proofs["w1"][2] if "loss" in e]


def test_world2_checkpoints_are_sharded(proofs):
    """At world 2 each rank wrote its own shard file (the sharded save the
    JAX test covers with 8 virtual devices)."""
    assert proofs["ckpt_w2"] == ["data_status.json", "meta.json", "shards.rank00000.json",
                                 "shards.rank00001.json",
                                 "state.rank00000-of-00002.safetensors",
                                 "state.rank00001-of-00002.safetensors"]


@pytest.mark.parametrize("step, batch, seq, z, classes", [
    (0, 8, 256, 16, 1000), (3, 8, 256, 16, 1000), (70, 8, 16, 8, 10), (5, 100, 4, 4, 7)])
def test_synth_batch_matches_jax(step, batch, seq, z, classes):
    jax_mod = _jax_script()
    want = jax_mod.make_synth_batch(step, batch, seq, z, num_classes=classes)
    got = tproof.make_synth_batch(step, batch, seq, z, num_classes=classes)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_state_digest_sees_every_part_of_the_state():
    """The digest moves with one bit of a master, of a moment, of the EMA,
    with the step, the schedule's count and a learning rate, and not
    otherwise."""
    import torch

    from bitdance_tpu_torch.models.imagenet_ar import ImageNetARConfig
    from bitdance_tpu_torch.train.imagenet_train import ImageNetTrainConfig, init_train_state

    cfg = ImageNetARConfig(dim=64, n_layer=1, n_head=2, diff_layers=1, diff_dim=64,
                           diff_adanln_layers=1, latent_dim=8, resolution=64,
                           cls_token_num=4, num_classes=10)
    state = init_train_state(cfg, ImageNetTrainConfig(), "cpu",
                             generator=torch.Generator().manual_seed(0))
    p = state.tx.params[0]
    state.tx.opt.state[p] = {"exp_avg": torch.zeros_like(p), "step": torch.tensor(0.0)}
    base = tproof.state_digest(state)
    assert tproof.state_digest(state) == base
    name = state.tx.names[0]

    def flipped(t):
        t.view(-1).view(torch.int32)[0] ^= 1
        return t

    for change, undo in (
            (lambda: flipped(p.data), lambda: flipped(p.data)),
            (lambda: flipped(state.tx.opt.state[p]["exp_avg"]),
             lambda: flipped(state.tx.opt.state[p]["exp_avg"])),
            (lambda: flipped(state.ema[name]), lambda: flipped(state.ema[name])),
            (lambda: setattr(state, "step", 1), lambda: setattr(state, "step", 0)),
            (lambda: setattr(state.tx, "count", 1), lambda: setattr(state.tx, "count", 0)),
            (lambda: state.tx.opt.param_groups[0].__setitem__("lr", 0.5),
             lambda: state.tx.opt.param_groups[0].__setitem__("lr", 0.0))):
        change()
        assert tproof.state_digest(state) != base
        undo()
        assert tproof.state_digest(state) == base
