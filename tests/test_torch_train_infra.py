"""The port's training infrastructure on the CPU: AdamW and its schedule
(``repro_torch.train.optimizer``) and the chunked cross entropy against the
reference's, the data pipeline bitwise the reference's, the checkpoint
format, the launcher (``repro_torch.launch.train``) with resume, and the
twin of ``examples/train_lm.py``.

Inputs come from ``np.random.default_rng``; tolerances are stated per test.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as j_pipeline
from repro.train import optimizer as j_opt
from repro.train import step as j_step
from repro_torch.ckpt.checkpoint import (latest_checkpoint, load_checkpoint,
                                         save_checkpoint)
from repro_torch.data import pipeline
from repro_torch.launch.train import main as train_main
from repro_torch.models import init_params
from repro_torch.models.convert import params_to_reference
from repro_torch.train import optimizer, step

from test_torch_train import smoke_configs


def rel_close(got, want, rel):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rel * max(float(np.abs(want).max()), 1e-30), err


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step_", [0, 1, 5, 10, 11, 60, 100, 150])
def test_schedule_matches_the_reference(step_):
    kw = dict(lr=3e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    got = optimizer.schedule(optimizer.AdamWConfig(**kw),
                             torch.tensor(step_, dtype=torch.int32))
    want = j_opt.schedule(j_opt.AdamWConfig(**kw),
                          jnp.asarray(step_, jnp.int32))
    assert got.dtype == torch.float32
    rel_close(got, want, 1e-6)


def _seeded_model_and_grads(arch: str, seed: int, grad_scale: float):
    """A smoke model with weights from ``default_rng(seed)``, and seeded
    gradients by parameter name."""
    _, cfg = smoke_configs(arch)
    rng = np.random.default_rng(seed)
    model = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.tensor(rng.normal(size=p.shape)
                                 .astype(np.float32)))
    grads = {n: torch.tensor((rng.normal(size=p.shape) * grad_scale)
                             .astype(np.float32))
             for n, p in model.named_parameters()}
    return cfg, model, grads


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "olmoe-1b-7b",
                                  "recurrentgemma-2b", "mamba2-130m"])
@pytest.mark.parametrize("grad_scale", [1e-3, 1.0], ids=["unclipped",
                                                         "clipped"])
def test_adamw_update_matches_the_reference(arch, grad_scale):
    """Three steps on identical parameters and gradients (the reference's
    tree built from the port's through ``params_to_reference``): the grad
    norm and lr within rel 1e-6, and every new parameter, m and v within
    rel 1e-6 + 2 d of its leaf, where d is the relative difference of the
    two grad norms.  ``grad_scale`` 1 clips (global norm >> 1): the clip
    scale 1 / norm then carries d into g, and 2 d into g * g.  Each
    framework sums the leaves' squares in its own order; on olmoe's smoke
    leaves the reference's f32 norm is 3.4e-7 from the f64 norm, the
    port's 3e-8.  Unclipped, d does not enter (the scale is 1)."""
    cfg, model, grads = _seeded_model_and_grads(arch, 3, grad_scale)
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    params = jax.tree.map(jnp.asarray,
                          params_to_reference(model.state_dict(), cfg))
    jgrads = jax.tree.map(jnp.asarray, params_to_reference(grads, cfg))
    jstate = j_opt.init_opt_state(params)
    state = optimizer.init_opt_state(model)
    d = 0.0
    for _ in range(3):
        params, jstate, jm = j_opt.adamw_update(
            j_opt.AdamWConfig(**ocfg), params, jgrads, jstate)
        state, m = optimizer.adamw_update(optimizer.AdamWConfig(**ocfg),
                                          model, grads, state)
        rel_close(m["grad_norm"], jm["grad_norm"], 1e-6)
        rel_close(m["lr"], jm["lr"], 1e-6)
        d = max(d, abs(float(m["grad_norm"]) / float(jm["grad_norm"]) - 1))
    assert int(state.step) == int(jstate.step) == 3
    clipped = float(m["grad_norm"]) > 1.0
    assert clipped == (grad_scale == 1.0)
    for got, want in ((model.state_dict(), params), (state.m, jstate.m),
                      (state.v, jstate.v)):
        got = params_to_reference(got, cfg)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            rel_close(g, w, 1e-6 + (2 * d if clipped else 0.0))


def test_weight_decay_follows_the_reference_rank():
    """Zero gradients: a step moves exactly the decayed leaves, by lr * wd
    * p.  Every block leaf is decayed (rank >= 2 in the reference, stacked
    over repeats), the 1-D ones too: norm gains, the qkv bias; the
    top-level ``ln_f`` is not, the embedding is."""
    cfg, model, _ = _seeded_model_and_grads("qwen2.5-3b", 4, 1.0)
    grads = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    ocfg = optimizer.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    optimizer.adamw_update(ocfg, model, grads,
                           optimizer.init_opt_state(model))
    decayed = {n for n, p in model.named_parameters()
               if not torch.equal(p, before[n])}
    names = set(before)
    assert decayed == {n for n in names if n != "ln_f.scale"}
    assert {"blocks.0.ln1.scale", "blocks.1.bq", "embed"} <= decayed
    assert optimizer.reference_ndim("blocks.1.bq", model.blocks[1].bq) == 2
    assert optimizer.reference_ndim("ln_f.scale", model.ln_f.scale) == 1
    lr = float(optimizer.schedule(ocfg, torch.tensor(1)))
    p0 = before["blocks.0.ln1.scale"]
    rel_close(model.blocks[0].ln1.scale, p0 - lr * 0.1 * p0, 1e-6)


def test_adamw_keeps_bf16_params_and_f32_state():
    cfg, model, grads = _seeded_model_and_grads("stablelm-12b", 5, 1.0)
    model.to(torch.bfloat16)
    state = optimizer.init_opt_state(model)
    state, _ = optimizer.adamw_update(optimizer.AdamWConfig(), model,
                                      grads, state)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert all(t.dtype == torch.float32 for t in state.m.values())
    assert state.step.dtype == torch.int32
    low, _ = optimizer.adamw_update(
        optimizer.AdamWConfig(mu_dtype=torch.bfloat16), model, grads,
        optimizer.init_opt_state(model))
    assert all(t.dtype == torch.bfloat16 for t in low.v.values())


def test_global_norm():
    ts = [torch.full((3,), 2.0), torch.full((2, 2), 1.0, dtype=torch.bfloat16)]
    assert float(optimizer.global_norm(ts)) == pytest.approx(4.0)


# ---------------------------------------------------------------------------
# chunked cross entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [32, 30], ids=["four-chunks", "one-chunk"])
def test_chunked_xent_and_grads_match_the_reference(s):
    """chunk 8: S = 32 runs four checkpointed chunks, S = 30 (not a
    multiple) one chunk, as the reference.  The loss within rel 1e-6, the
    gradients of x and the head within 1e-5 of their max."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, s, 16)).astype(np.float32)
    head = rng.normal(size=(16, 50)).astype(np.float32)
    labels = rng.integers(0, 50, size=(2, s)).astype(np.int32)
    want, (wx, wh) = jax.value_and_grad(
        lambda a, h: j_step.chunked_xent(a, h, jnp.asarray(labels), 8),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(head))
    tx, th = (torch.tensor(a, requires_grad=True) for a in (x, head))
    got = step.chunked_xent(tx, th, torch.tensor(labels).long(), 8)
    gx, gh = torch.autograd.grad(got, (tx, th))
    rel_close(got, want, 1e-6)
    rel_close(gx, wx, 1e-5)
    rel_close(gh, wh, 1e-5)


def test_chunked_xent_checkpoints_each_chunk(monkeypatch):
    calls = []

    def counted(fn, *args, **kw):
        calls.append(args[0].shape[1])
        return torch.utils.checkpoint.checkpoint(fn, *args, **kw)
    monkeypatch.setattr(step, "checkpoint", counted)
    x = torch.zeros(1, 24, 4)
    step.chunked_xent(x, torch.zeros(4, 5), torch.zeros(1, 24).long(), 8)
    step.chunked_xent(x, torch.zeros(4, 5), torch.zeros(1, 24).long(), 10)
    assert calls == [8, 8, 8, 24]


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,gb,hosts", [(1000, 32, 8, 1),
                                                (50280, 64, 4, 2),
                                                (151936, 16, 2, 1)])
def test_pipeline_is_bitwise_the_reference(vocab, seq, gb, hosts):
    for host in range(hosts):
        kw = dict(vocab=vocab, seq_len=seq, global_batch=gb, seed=3,
                  n_hosts=hosts, host_id=host)
        cfg, jcfg = pipeline.DataConfig(**kw), j_pipeline.DataConfig(**kw)
        assert pipeline.host_slice(cfg) == j_pipeline.host_slice(jcfg)
        for s in (0, 7):
            got, want = pipeline.sample_batch(cfg, s), \
                j_pipeline.sample_batch(jcfg, s)
            for k in ("inputs", "labels"):
                assert got[k].dtype == want[k].dtype == np.int32
                np.testing.assert_array_equal(got[k], want[k])
            got = pipeline.sample_embedding_batch(cfg, s, 24)
            want = j_pipeline.sample_embedding_batch(jcfg, s, 24)
            assert got["inputs"].tobytes() == want["inputs"].tobytes()
            np.testing.assert_array_equal(got["labels"], want["labels"])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tree():
    rng = np.random.default_rng(7)
    return {"f32": torch.tensor(rng.normal(size=(3, 4)).astype(np.float32)),
            "bf16": torch.tensor(rng.normal(size=(5,))).bfloat16(),
            "nest": [torch.arange(6, dtype=torch.int32).reshape(2, 3),
                     torch.tensor(-3, dtype=torch.int64)],
            "opt": optimizer.AdamWState(
                step=torch.tensor(9, dtype=torch.int32),
                m={"a": torch.ones(2)}, v={"a": torch.zeros(2)})}


def test_checkpoint_round_trip(tmp_path):
    tree = _tree()
    f = save_checkpoint(str(tmp_path), tree, 12)
    assert os.path.basename(f) == "step_00000012.ckpt"
    assert latest_checkpoint(str(tmp_path)) == f
    assert not [n for n in os.listdir(tmp_path) if n.startswith("tmp.")
                or n.endswith(".tmp")]
    got, s = load_checkpoint(f, tree, device="cpu")
    assert s == 12
    assert isinstance(got["opt"], optimizer.AdamWState)
    assert isinstance(got["nest"], list)
    for (a, b) in ((got["f32"], tree["f32"]), (got["bf16"], tree["bf16"]),
                   (got["nest"][0], tree["nest"][0]),
                   (got["nest"][1], tree["nest"][1]),
                   (got["opt"].step, tree["opt"].step),
                   (got["opt"].m["a"], tree["opt"].m["a"])):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_checkpoint_latest_moves_and_a_corrupt_leaf_raises(tmp_path):
    tree = _tree()
    assert latest_checkpoint(str(tmp_path)) is None
    f1 = save_checkpoint(str(tmp_path), tree, 1)
    f2 = save_checkpoint(str(tmp_path), tree, 2)
    assert latest_checkpoint(str(tmp_path)) == f2
    raw = bytearray(open(f1, "rb").read())
    raw[8 + 3] ^= 0xFF                       # a byte of the first leaf
    with open(f1, "wb") as fh:
        fh.write(raw)
    with pytest.raises(IOError, match="crc mismatch on leaf f32"):
        load_checkpoint(f1, tree, device="cpu")
    with pytest.raises(KeyError, match="missing leaf extra"):
        load_checkpoint(f2, {**tree, "extra": torch.zeros(1)}, device="cpu")
    os.remove(f2)
    assert latest_checkpoint(str(tmp_path)) is None


# ---------------------------------------------------------------------------
# the launcher and the example twin
# ---------------------------------------------------------------------------

SMOKE = ["--arch", "qwen2.5-3b", "--smoke", "--batch", "2", "--seq", "16",
         "--log-every", "100", "--device", "cpu"]


def test_training_driver_end_to_end(tmp_path):
    """As the reference's tests/test_system.py: 14 steps with checkpoints
    every 7, then a resume to 16 runs steps 14 and 15 only."""
    ck = str(tmp_path / "ck")
    losses = train_main(SMOKE + ["--steps", "14", "--ckpt-dir", ck,
                                 "--ckpt-every", "7"])
    assert len(losses) == 14 and np.isfinite(losses).all()
    assert latest_checkpoint(ck).endswith("step_00000014.ckpt")
    losses2 = train_main(SMOKE + ["--steps", "16", "--ckpt-dir", ck,
                                  "--resume"])
    assert len(losses2) == 2


def test_resume_is_bitwise_the_straight_run(tmp_path):
    """16 steps with checkpoints every 8; ``LATEST`` pointed back at the
    step-8 file and a resume with the same ``--steps`` (the lr schedule
    depends on it) gives steps 8-15's losses bit for bit."""
    ck = str(tmp_path / "ck")
    args = SMOKE + ["--steps", "16", "--ckpt-dir", ck, "--ckpt-every", "8"]
    straight = train_main(args)
    with open(os.path.join(ck, "LATEST"), "w") as f:
        f.write("step_00000008.ckpt")
    resumed = train_main(args + ["--resume"])
    assert resumed == straight[8:]


def test_launcher_trains_a_stub_frontend_arch_with_microbatches():
    losses = train_main(["--arch", "musicgen-medium", "--smoke", "--steps",
                         "3", "--batch", "4", "--seq", "8",
                         "--microbatches", "2", "--device", "cpu"])
    assert len(losses) == 3 and np.isfinite(losses).all()


def test_train_lm_twin_runs_the_full_mamba2_130m(tmp_path):
    """The twin's own config (full mamba2-130m, bf16, lr 1e-3), cut to two
    steps of batch 1 x 32 on the CPU; a rerun resumes (nothing left at
    ckpt-every 50, so it starts over)."""
    from repro_torch.examples import train_lm
    out = train_lm.main(["--steps", "2", "--batch", "1", "--seq", "32",
                         "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert out["arch"] == "mamba2-130m" and len(out["losses"]) == 2
    assert np.isfinite(out["losses"]).all()
    assert latest_checkpoint(str(tmp_path)) is None
