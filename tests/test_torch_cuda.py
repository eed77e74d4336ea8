"""Port kernels vs their plain versions on the card (small shapes).

Skipped without a CUDA device. Imports no JAX, so where JAX is not installed
it runs without the JAX package's conftest:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def test_decode_attention_kernel(dev):
    from bitdance_tpu_torch.ops.decode_attention import (
        decode_attention,
        decode_attention_reference,
    )

    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((3, 16, 8, 128), generator=g, device=dev).bfloat16()
    k = torch.randn((3, 2, 300, 128), generator=g, device=dev).bfloat16()
    v = torch.randn((3, 2, 300, 128), generator=g, device=dev).bfloat16()
    kv_len = torch.tensor([300, 170, 40], dtype=torch.int32, device=dev)
    kv_start = torch.tensor([0, 37, 40], dtype=torch.int32, device=dev)
    n = decode_attention.launches
    with torch.no_grad():
        got = decode_attention(q, k, v, kv_len, kv_start)
        want = decode_attention_reference(q, k, v, kv_len, kv_start)
    assert decode_attention.launches == n + 1
    assert (got[2] == 0).all()                      # empty window
    assert (got.float() - want.float()).abs().max().item() < 2e-2


def test_sampler_kernel_small_head(dev):
    from bitdance_tpu_torch.io.random_init import init_head
    from bitdance_tpu_torch.ops.fused_head import (
        em_precompute,
        fused_em_sample,
        fused_em_sample_reference,
    )

    g = torch.Generator(device=dev).manual_seed(0)
    head = init_head(dict(ch_target=32, ch_cond=256, ch_latent=256,
                          depth_latent=4, depth_adanln=2, parallel_num=16),
                     dev, torch.bfloat16, g)
    s = head._stack_for_sampler()
    cond = torch.randn((4, 16, 256), generator=g, device=dev)
    c_emb = cond.reshape(64, 256) @ s["cond_w"].float().t() + s["cond_b"]
    t_all = torch.linspace(0.0, 0.95, 5)
    dt_all = torch.cat([t_all[1:] - t_all[:-1], torch.zeros(1)])
    mods = em_precompute(s, c_emb, t_all)
    x0 = torch.randn((32, 32), generator=g, device=dev)
    noise = torch.randn((4, 32, 32), generator=g, device=dev)
    kw = dict(num_blocks=4, num_ada=2, n_head=2, groups=4)
    with torch.no_grad():
        got = fused_em_sample(s, x0, noise, mods, t_all, dt_all, 3.0, **kw)
        want = fused_em_sample_reference(s, x0, noise, mods, t_all, dt_all,
                                         3.0, **kw)
        part = fused_em_sample(s, x0, noise[:2], mods[:2], t_all[:2],
                               dt_all[:2], 3.0, final_chunk=False, **kw)
        part_ref = fused_em_sample_reference(s, x0, noise[:2], mods[:2],
                                             t_all[:2], dt_all[:2], 3.0,
                                             final_chunk=False, **kw)
    rel = (got - want).abs().max() / want.abs().max()
    assert rel.item() < 5e-2
    assert ((part - part_ref).abs().max() / part_ref.abs().max()).item() < 5e-2


def _packed_ids(lens, dev):
    block = torch.cat([torch.arange(n) for n in lens])
    doc = torch.cat([torch.full((n,), i) for i, n in enumerate(lens)])
    return block.int().to(dev), doc.int().to(dev)


@pytest.mark.parametrize("b,l,hq,hkv,d,lens", [
    (2, 200, 4, 2, 64, (200,)),           # ragged, GQA, causal
    (1, 300, 2, 2, 128, (130, 170)),      # two packed documents
    (2, 230, 4, 1, 64, None),             # unsorted ids, rows that see nothing
])
def test_flash_attention_kernels(dev, b, l, hq, hkv, d, lens):
    """o, lse, dq, dk, dv of the kernels vs the plain version's values and
    autograd grads (bf16 inputs; bounds a few bf16 ulps of each output).
    Unsorted ids check that the tile skip stays sound for any id order."""
    from bitdance_tpu_torch.ops.attention import (
        flash_attention,
        flash_attention_reference,
        flash_bwd_dkv,
        flash_bwd_dq,
        flash_fwd,
    )

    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((b, l, h, d), generator=g, device=dev).bfloat16()
               for h in (hq, hkv, hkv))
    w = torch.randn((b, l, hq, d), generator=g, device=dev)
    if lens is None:
        block = torch.randint(0, 60, (l,), generator=g, device=dev).int()
        doc = torch.randint(0, 3, (l,), generator=g, device=dev).int()
        qdoc = torch.where(torch.arange(l, device=dev) < 7, 9, doc).int()
        ids = (block.expand(b, l), qdoc.expand(b, l), block.expand(b, l),
               doc.expand(b, l))
    else:
        block, doc = _packed_ids(lens, dev)
        ids = (block.expand(b, l), doc.expand(b, l)) * 2
    counts = (flash_fwd.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches)
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o_ref, lse_ref = flash_attention_reference(qr, kr, vr, *ids, return_lse=True)
    (o_ref.float() * w).sum().backward()
    qk, kk, vk = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o = flash_attention(qk, kk, vk, *ids)
    (o.float() * w).sum().backward()
    _, lse = flash_fwd(q, k, v, *ids, d ** -0.5)
    torch.cuda.synchronize()
    assert (flash_fwd.launches, flash_bwd_dq.launches,
            flash_bwd_dkv.launches) == tuple(c + n for c, n in zip(counts, (2, 1, 1)))
    err = lambda a, r: ((a.float() - r.float()).abs().max()  # noqa: E731
                        / r.float().abs().max()).item()
    assert err(o, o_ref) < 2e-2
    assert (lse - lse_ref).abs().max().item() < 2e-2
    if lens is None:
        assert (o[:, :7] == 0).all() and (lse[:, :, :7] == 1e30).all()
    for got, want in ((qk.grad, qr.grad), (kk.grad, kr.grad), (vk.grad, vr.grad)):
        assert err(got, want) < 3e-2


# (b, L, hq, hkv, d, ids): ragged L at D 64 and D 128, GQA 40 / 8, a packed
# doc boundary inside a tile, rows that see no key, and unsorted ids
BACKWARD_CASES = {
    "causal_ragged_d64": (2, 200, 4, 4, 64, (200,)),
    "gqa40_8_d128_docs": (1, 330, 40, 8, 128, (140, 190)),
    "packed_ragged_d64": (2, 459, 4, 2, 64, (100, 230, 129)),
    "unsorted_empty_rows_d128": (1, 230, 4, 1, 128, None),
}


@pytest.mark.parametrize("name", list(BACKWARD_CASES))
def test_flash_backward_kernels(dev, name):
    """#8 and #9 vs their plain versions on the forward's lse (bounds:
    chip_smoke.py's _FLASH_BOUNDS, relative to max |value|), with dead,
    partial and full tile pairs where the ids are sorted; rows that see no
    key get dq 0; two launches bit-equal; #11 / #12 equal to them."""
    from bitdance_tpu_torch.ops.attention import (
        TILE,
        TILE_DEAD,
        TILE_FULL,
        TILE_PARTIAL,
        flash_bwd_dkv,
        flash_bwd_dkv_reference,
        flash_bwd_dkv_sparse,
        flash_bwd_dq,
        flash_bwd_dq_reference,
        flash_bwd_dq_sparse,
        flash_fwd,
        sparse_plan,
        tile_classes,
    )

    b, L, hq, hkv, d, lens = BACKWARD_CASES[name]
    g = torch.Generator(device=dev).manual_seed(3)
    q, do = (torch.randn((b, L, hq, d), generator=g, device=dev).bfloat16() for _ in "ab")
    k, v = (torch.randn((b, L, hkv, d), generator=g, device=dev).bfloat16() for _ in "ab")
    if lens is None:
        block = torch.randint(0, 60, (L,), generator=g, device=dev).int()
        doc = torch.randint(0, 3, (L,), generator=g, device=dev).int()
        qdoc = torch.where(torch.arange(L, device=dev) < 7, 9, doc).int()
        ids = tuple(t.expand(b, L).contiguous() for t in (block, qdoc, block, doc))
    else:
        block, doc = _packed_ids(lens, dev)
        ids = tuple(t.expand(b, L).contiguous() for t in (block, doc, block, doc))
        classes = set(tile_classes(*ids, TILE, TILE).unique().tolist())
        assert classes == {TILE_DEAD, TILE_PARTIAL, TILE_FULL}
    sc = d ** -0.5
    o, lse = flash_fwd(q, k, v, *ids, sc)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = flash_bwd_dq(q, k, v, do, lse, delta, *ids, sc)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, *ids, sc)
    dq_ref = flash_bwd_dq_reference(q, k, v, do, lse, delta, *ids, sc)
    dk_ref, dv_ref = flash_bwd_dkv_reference(q, k, v, do, lse, delta, *ids, sc)
    rel = lambda a, r: ((a.float() - r.float()).abs().max()  # noqa: E731
                        / r.float().abs().max()).item()
    for got, want, bound in ((dq, dq_ref, 1.5e-2), (dk, dk_ref, 1.5e-2), (dv, dv_ref, 1.2e-2)):
        assert torch.isfinite(got).all() and rel(got, want) < bound
    if lens is None:
        assert (lse[:, :, :7] == 1e30).all() and (dq[:, :7] == 0).all()
    assert torch.equal(dq, flash_bwd_dq(q, k, v, do, lse, delta, *ids, sc))
    assert all(map(torch.equal, (dk, dv), flash_bwd_dkv(q, k, v, do, lse, delta, *ids, sc)))
    plan = sparse_plan(*ids, -(-L // TILE))
    assert torch.equal(dq, flash_bwd_dq_sparse(q, k, v, do, lse, delta, *ids, plan, sc))
    assert all(map(torch.equal, (dk, dv),
                   flash_bwd_dkv_sparse(q, k, v, do, lse, delta, *ids, plan, sc)))


@pytest.mark.parametrize("name", list(BACKWARD_CASES))
def test_flash_forward_kernels(dev, name):
    """#7 vs its plain version (bounds: chip_smoke.py's _FLASH_BOUNDS, o
    relative to max |o|, lse to max |lse| over the rows that see a key),
    with dead, partial and full tile pairs where the ids are sorted; rows
    that see no key get o 0 and lse 1e30; two launches bit-equal; #10 equal
    to it."""
    from bitdance_tpu_torch.ops.attention import (
        TILE,
        TILE_DEAD,
        TILE_FULL,
        TILE_PARTIAL,
        flash_attention_reference,
        flash_fwd,
        flash_fwd_sparse,
        sparse_plan,
        tile_classes,
    )

    b, L, hq, hkv, d, lens = BACKWARD_CASES[name]
    g = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn((b, L, hq, d), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((b, L, hkv, d), generator=g, device=dev).bfloat16() for _ in "ab")
    if lens is None:
        block = torch.randint(0, 60, (L,), generator=g, device=dev).int()
        doc = torch.randint(0, 3, (L,), generator=g, device=dev).int()
        qdoc = torch.where(torch.arange(L, device=dev) < 7, 9, doc).int()
        ids = tuple(t.expand(b, L).contiguous() for t in (block, qdoc, block, doc))
    else:
        block, doc = _packed_ids(lens, dev)
        ids = tuple(t.expand(b, L).contiguous() for t in (block, doc, block, doc))
        classes = set(tile_classes(*ids, TILE, TILE).unique().tolist())
        assert classes == {TILE_DEAD, TILE_PARTIAL, TILE_FULL}
    sc = d ** -0.5
    with torch.no_grad():
        o, lse = flash_fwd(q, k, v, *ids, sc)
        o_ref, lse_ref = flash_attention_reference(q, k, v, *ids, sc, return_lse=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert lse.shape == (b, hq, L) and torch.isfinite(o).all()
    live = lse_ref < 1e29
    assert torch.equal(live, lse < 1e29)
    rel_o = ((o.float() - o_ref.float()).abs().max() / o_ref.float().abs().max()).item()
    rel_lse = ((lse[live] - lse_ref[live]).abs().max() / lse_ref[live].abs().max()).item()
    assert rel_o < 1.2e-2 and rel_lse < 1e-6
    if lens is None:
        assert (lse[:, :, :7] == 1e30).all() and (o[:, :7] == 0).all()
    again = flash_fwd(q, k, v, *ids, sc)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    plan = sparse_plan(*ids, -(-L // TILE))
    sparse = flash_fwd_sparse(q, k, v, *ids, plan, sc)
    assert torch.equal(o, sparse[0]) and torch.equal(lse, sparse[1])


def test_kernels_refuse_grad(dev):
    from bitdance_tpu_torch.ops.decode_attention import decode_attention

    q = torch.zeros((1, 1, 2, 128), device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    k = torch.zeros((1, 1, 4, 128), device=dev, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="no backward"):
        decode_attention(q, k, k, torch.ones(1, dtype=torch.int32, device=dev))


def _block_weights(g, dev, c, n_out, n_in):
    return (torch.randn((n_out, n_in), generator=g, device=dev) * n_in ** -0.5).bfloat16()


@pytest.mark.parametrize("rows,c", [(8, 1280), (512, 768), (77, 256)])
def test_fused_mlp_block_kernel(dev, rows, c):
    """#14 (both products on the head GEMM) vs its plain version at the
    same K splits (bf16; bounds a few bf16 ulps of the output) and two
    launches bit-equal; mods read through a row stride and, for the gate,
    stride 0; a shape the head GEMM cannot take raises."""
    from bitdance_tpu_torch.ops.fused_block import (
        fused_mlp_block,
        fused_mlp_block_reference,
        mlp_block_plans,
    )

    g = torch.Generator(device=dev).manual_seed(0)
    h = c * 3 // 2
    x = torch.randn((rows, c), generator=g, device=dev).bfloat16()
    ada = (0.5 * torch.randn((rows, 3 * c), generator=g, device=dev)).bfloat16()
    scale, shift, _ = ada.chunk(3, dim=-1)
    gate = ada[:1, 2 * c:].expand(rows, c)
    ln_w = (1 + 0.1 * torch.randn(c, generator=g, device=dev)).bfloat16()
    ln_b = (0.1 * torch.randn(c, generator=g, device=dev)).bfloat16()
    w1, w2 = _block_weights(g, dev, c, 2 * h, c), _block_weights(g, dev, c, c, h)
    b1 = (0.1 * torch.randn(2 * h, generator=g, device=dev)).bfloat16()
    b2 = (0.1 * torch.randn(c, generator=g, device=dev)).bfloat16()
    args = (x, scale, shift, gate, ln_w, ln_b, w1, b1, w2, b2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = dict(zip(("w1", "w2"), (p.splits for p in mlp_block_plans(rows, c, h, sms))))
    n = fused_mlp_block.launches
    with torch.no_grad():
        got, again = fused_mlp_block(*args), fused_mlp_block(*args)
        want = fused_mlp_block_reference(*args, splits=splits)
    torch.cuda.synchronize()
    assert fused_mlp_block.launches == n + 2 and got.dtype == torch.bfloat16
    assert torch.equal(got, again)
    err = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
    assert err < 2e-2
    narrow = (x[:, :c - 64].contiguous(), scale[:, :c - 64], shift[:, :c - 64],
              gate[:, :c - 64], ln_w[:c - 64], ln_b[:c - 64],
              w1[:, :c - 64].contiguous(), b1, w2[:c - 64].contiguous(), b2[:c - 64])
    with pytest.raises(ValueError, match="head GEMM"):       # C % 128 != 0
        fused_mlp_block(*narrow)


@pytest.mark.parametrize("G,W,c,nh", [(32, 16, 768, 12), (64, 16, 768, 12), (4, 16, 256, 2),
                                       (3, 40, 256, 4)])
def test_fused_attn_block_kernel(dev, G, W, c, nh):
    """#15 (qkv and wo on the head GEMM, window attention on fp32 qkv) vs
    its plain version at the same K splits: B-16x width at its 512 and 1024
    rows, head dim 128, and a ragged window of 40 rows; two launches
    bit-equal; shapes the kernels cannot take raise."""
    from bitdance_tpu_torch.ops.fused_block import (
        attn_block_plans,
        fused_attn_block,
        fused_attn_block_reference,
    )

    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((G, W, c), generator=g, device=dev).bfloat16()
    ada = (0.5 * torch.randn((G, W, 3 * c), generator=g, device=dev)).bfloat16()
    scale, shift, gate = ada.chunk(3, dim=-1)
    ln_w = (1 + 0.1 * torch.randn(c, generator=g, device=dev)).bfloat16()
    ln_b = (0.1 * torch.randn(c, generator=g, device=dev)).bfloat16()
    wqkv, wo = _block_weights(g, dev, c, 3 * c, c), _block_weights(g, dev, c, c, c)
    bqkv = (0.1 * torch.randn(3 * c, generator=g, device=dev)).bfloat16()
    bo = (0.1 * torch.randn(c, generator=g, device=dev)).bfloat16()
    args = (x, scale, shift, gate, ln_w, ln_b, wqkv, bqkv, wo, bo, nh)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = dict(zip(("qkv", "wo"), (p.splits for p in attn_block_plans(G * W, c, sms))))
    n = fused_attn_block.launches
    with torch.no_grad():
        got, again = fused_attn_block(*args), fused_attn_block(*args)
        want = fused_attn_block_reference(*args, splits=splits)
    torch.cuda.synchronize()
    assert fused_attn_block.launches == n + 2 and got.dtype == torch.bfloat16
    assert torch.equal(got, again)
    err = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
    assert err < 2e-2
    with pytest.raises(ValueError, match="head dims"):           # head dim 32
        fused_attn_block(*args[:-1], 2 * nh if c // nh == 64 else 4 * nh)
    narrow = (x[..., :c - 64].contiguous(), scale[..., :c - 64], shift[..., :c - 64],
              gate[..., :c - 64], ln_w[:c - 64], ln_b[:c - 64],
              wqkv[:3 * (c - 64), :c - 64].contiguous(), bqkv[:3 * (c - 64)],
              wo[:c - 64, :c - 64].contiguous(), bo[:c - 64], (c - 64) // 64)
    with pytest.raises(ValueError, match="head GEMM"):       # C % 128 != 0
        fused_attn_block(*narrow)


def test_sampler_kernel_non_round_trans_encoder(dev):
    """Kernel #2's route (fp32 residual) on a TransEncoder whose block
    weights (40 MB a block) the router sends to #2: C 1536, H 2304, 2 blocks,
    one image's 128 rows in windows of 64, the products on the head GEMM, vs
    its plain version on the plan's splits; two calls bit-equal."""
    from bitdance_tpu_torch.io.random_init import init_head
    from bitdance_tpu_torch.ops.fused_head import (
        em_precompute,
        fused_em_sample,
        fused_em_sample_reference,
        rounds_residual,
        sampler_plans,
    )

    g = torch.Generator(device=dev).manual_seed(5)
    head = init_head(dict(ch_target=32, ch_cond=256, ch_latent=1536, depth_latent=2,
                          depth_adanln=2, parallel_num=64), dev, torch.bfloat16, g)
    s = head._stack_for_sampler()
    assert not rounds_residual(s, 2, True)
    cond = torch.randn((128, 256), generator=g, device=dev)
    c_emb = cond @ s["cond_w"].float().t() + s["cond_b"]
    t_all = torch.linspace(0.0, 0.95, 5)
    dt_all = torch.cat([t_all[1:] - t_all[:-1], torch.zeros(1)])
    mods = em_precompute(s, c_emb, t_all)
    x0 = torch.randn((64, 32), generator=g, device=dev)
    noise = torch.randn((4, 64, 32), generator=g, device=dev)
    kw = dict(num_blocks=2, num_ada=2, n_head=12, groups=2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = {k: p.splits for k, p in sampler_plans(128, 1536, 2304, True, sms).items()}
    with torch.no_grad():
        got = fused_em_sample(s, x0, noise, mods, t_all, dt_all, 3.0, **kw)
        again = fused_em_sample(s, x0, noise, mods, t_all, dt_all, 3.0, **kw)
        want = fused_em_sample_reference(s, x0, noise, mods, t_all, dt_all, 3.0,
                                         splits=splits, **kw)
    assert torch.equal(got, again)
    rel = (got - want).abs().max() / want.abs().max()
    assert torch.isfinite(got).all() and rel.item() < 5e-2


def test_sampler_kernel_mlp_encoder(dev):
    """The whole sampler's MlpEncoder family (3 mods, no attention,
    unbounded) vs its plain version, small head."""
    from bitdance_tpu_torch.io.random_init import init_head
    from bitdance_tpu_torch.ops.fused_head import (
        em_precompute,
        fused_em_sample,
        fused_em_sample_reference,
    )

    g = torch.Generator(device=dev).manual_seed(2)
    head = init_head(dict(ch_target=16, ch_cond=256, ch_latent=256,
                          depth_latent=4, depth_adanln=2, attention=False,
                          use_swiglu=False), dev, torch.bfloat16, g)
    s = head._stack_for_sampler()
    assert "wqkv" not in s and s["modcat_w"].shape[0] == (2 * 3 + 2) * 256
    cond = torch.randn((24, 256), generator=g, device=dev)
    c_emb = cond @ s["cond_w"].float().t() + s["cond_b"]
    t_all = torch.linspace(0.0, 0.95, 5)
    dt_all = torch.cat([t_all[1:] - t_all[:-1], torch.zeros(1)])
    mods = em_precompute(s, c_emb, t_all)
    x0 = torch.randn((12, 16), generator=g, device=dev)
    noise = torch.randn((4, 12, 16), generator=g, device=dev)
    kw = dict(num_blocks=4, num_ada=2, attention=False, bounded=False)
    with torch.no_grad():
        got = fused_em_sample(s, x0, noise, mods, t_all, dt_all, 3.0, **kw)
        want = fused_em_sample_reference(s, x0, noise, mods, t_all, dt_all,
                                         3.0, **kw)
    rel = (got - want).abs().max() / want.abs().max()
    assert rel.item() < 5e-2


@pytest.mark.parametrize("m,n,k,dtype", [(132, 192, 256, torch.bfloat16),
                                         (5, 64, 384, torch.float32),
                                         (1, 1024, 5120, torch.bfloat16),
                                         (132, 1024, 5120, torch.bfloat16),
                                         (300, 320, 512, torch.float32),
                                         (5, 64, 17408, torch.bfloat16)])
def test_w4a8_matmul_kernel(dev, m, n, k, dtype):
    """K1 vs its plain version (exact integer sums): the same int8 rows,
    so only the dtype of the output can differ."""
    from bitdance_tpu_torch.ops.int4 import (
        int4_matmul,
        int4_matmul_reference,
        quantize_linear_int4,
    )
    from bitdance_tpu_torch.ops.int8 import quantize_rows

    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((m, k), generator=g, device=dev).to(dtype)
    w = quantize_linear_int4(torch.randn((n, k), generator=g, device=dev))
    n0 = int4_matmul.launches
    with torch.no_grad():
        got = int4_matmul(x, w)
        want = int4_matmul_reference(*quantize_rows(x), w.q, w.s, dtype)
    torch.cuda.synchronize()
    assert int4_matmul.launches == n0 + 1 and got.dtype == dtype
    err = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
    assert err < 1e-5


def _w4a8_inputs(dev, m, n, k, seed):
    from bitdance_tpu_torch.ops.int4 import Q4Tensor

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=dev).bfloat16()
    q = torch.randint(-128, 128, (n, k // 2), generator=g, device=dev, dtype=torch.int8)
    s = torch.rand((n,), generator=g, device=dev) * 1e-2 + 1e-3
    return x, Q4Tensor(q=q, s=s)


@pytest.mark.parametrize("n_splits", [1, None, "max"])
def test_w4a8_split_counts_are_bit_equal(dev, n_splits):
    """N 1024 (k_proj's) with every tile whole, at the picked schedule and
    split into every stage: exact against plain, and equal bits."""
    from bitdance_tpu_torch.ops.int4 import int4_matmul, int4_matmul_reference, w4a8_stages
    from bitdance_tpu_torch.ops.int8 import quantize_rows

    x, w = _w4a8_inputs(dev, 128, 1024, 5120, 21)
    splits = w4a8_stages(5120) if n_splits == "max" else n_splits
    with torch.no_grad():
        got = int4_matmul(x, w, n_splits=splits)
        again = int4_matmul(x, w, n_splits=splits)
        whole = int4_matmul(x, w, n_splits=1)
        want = int4_matmul_reference(*quantize_rows(x), w.q, w.s, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, again) and torch.equal(got, whole)


def test_w4a8_poisoned_inputs_catch_layout_faults(dev):
    """On inputs where a swapped nibble plane, a k chunk read 32 columns
    off or a transposed store each move the plain version's output by far
    more than a bf16 ulp, the kernel equals the plain version exactly."""
    from bitdance_tpu_torch.ops.int4 import int4_matmul, int4_matmul_reference, pack_int4
    from bitdance_tpu_torch.ops.int4 import Q4Tensor, unpack_int4
    from bitdance_tpu_torch.ops.int8 import quantize_rows

    m = n = 128
    x, w = _w4a8_inputs(dev, m, n, 1024, 22)
    x[:, 512:] *= 4.0                                     # the high plane's columns dominate
    lo, hi = unpack_int4(w.q)
    lo = torch.where(torch.arange(512, device=dev) % 64 < 32, lo, -lo)  # k chunks alternate
    w = Q4Tensor(q=pack_int4(torch.cat([lo, hi], dim=1)), s=w.s)
    xq, sx = quantize_rows(x)
    with torch.no_grad():
        got = int4_matmul(x, w)
        want = int4_matmul_reference(xq, sx, w.q, w.s, torch.bfloat16)
        swapped = int4_matmul_reference(xq, sx, pack_int4(torch.cat([hi, lo], dim=1)), w.s,
                                        torch.bfloat16)
        shifted = int4_matmul_reference(torch.roll(xq, 32, dims=1), sx, w.q, w.s,
                                        torch.bfloat16)
    torch.cuda.synchronize()
    scale = want.float().abs().max()
    for wrong in (swapped, shifted, want.t()):
        assert (wrong.float() - want.float()).abs().max() > 0.1 * scale
    assert torch.equal(got, want)


def test_w4a8_graph_capture_equals_lone_calls(dev):
    """Two products of different shapes captured in one CUDA graph (each
    call its own scratch) give the bits of lone calls (the shared scratch)."""
    from bitdance_tpu_torch.ops.int4 import int4_matmul

    xa, wa = _w4a8_inputs(dev, 128, 1024, 5120, 23)      # k_proj: split tiles
    xb, wb = _w4a8_inputs(dev, 132, 17408, 1024, 24)     # a split tail
    with torch.no_grad():
        lone = (int4_matmul(xa, wa), int4_matmul(xb, wb))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            int4_matmul(xa, wa)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = (int4_matmul(xa, wa), int4_matmul(xb, wb))
        graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o, want in zip(outs, lone))


@pytest.mark.parametrize("quant", [False, True])
def test_decode_attention_fusedkv_kernel(dev, quant):
    """K2 vs its plain version on a fused bf16 or int8 buffer: GQA, per-row
    windows with kv_start > 0, an empty window."""
    from bitdance_tpu_torch.ops.decode_attention import (
        decode_attention_fusedkv,
        decode_attention_fusedkv_reference,
        pack_kv_rows,
        quantize_kv_rows,
    )

    g = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn((3, 16, 8, 128), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((3, 300, 2, 128), generator=g, device=dev).bfloat16()
            for _ in range(2))
    kv, sc = quantize_kv_rows(k, v) if quant else (pack_kv_rows(k, v), None)
    kv = kv.contiguous()
    sc = sc.contiguous() if quant else None
    kv_len = torch.tensor([300, 170, 40], dtype=torch.int32, device=dev)
    kv_start = torch.tensor([0, 37, 40], dtype=torch.int32, device=dev)
    n = decode_attention_fusedkv.launches
    with torch.no_grad():
        got = decode_attention_fusedkv(q, kv, kv_len, kv_start, sc)
        want = decode_attention_fusedkv_reference(q, kv, kv_len, kv_start, sc)
    torch.cuda.synchronize()
    assert decode_attention_fusedkv.launches == n + 1
    assert (got[2] == 0).all()
    assert (got.float() - want.float()).abs().max().item() < 2e-2


@pytest.mark.parametrize("fmt", ["bf16", "fused_bf16", "int8"])
@pytest.mark.parametrize("splits", ["one", "tiles"])
def test_decode_attention_split_counts(dev, fmt, splits):
    """Both wrappers with n_splits forced to 1 and to the cache's tile count
    (5 tiles of 64 keys; windows that start and end inside tiles and on
    them, an empty one): within a few bf16 ulps of the plain version, the
    empty window exactly 0, and two launches bit-equal."""
    from bitdance_tpu_torch.ops.decode_attention import (
        decode_attention,
        decode_attention_fusedkv,
        decode_attention_fusedkv_reference,
        decode_attention_reference,
        quantize_kv_rows,
    )

    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((4, 16, 8, 128), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((4, 2, 300, 128), generator=g, device=dev).bfloat16()
            for _ in range(2))
    kv_len = torch.tensor([300, 170, 256, 40], dtype=torch.int32, device=dev)
    kv_start = torch.tensor([0, 37, 64, 40], dtype=torch.int32, device=dev)
    n_splits = 1 if splits == "one" else 5
    if fmt == "bf16":
        run = lambda: decode_attention(q, k, v, kv_len, kv_start,  # noqa: E731
                                       n_splits=n_splits)
        want = decode_attention_reference(q, k, v, kv_len, kv_start)
    else:
        if fmt == "int8":
            kv, sc = quantize_kv_rows(k.transpose(1, 2), v.transpose(1, 2))
            kv, sc = kv.contiguous(), sc.contiguous()
        else:
            kv, sc = torch.cat([k, v], dim=-1), None
        run = lambda: decode_attention_fusedkv(q, kv, kv_len, kv_start, sc,  # noqa: E731
                                               n_splits=n_splits)
        want = decode_attention_fusedkv_reference(q, kv, kv_len, kv_start, sc)
    with torch.no_grad():
        got, again = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert (got[3] == 0).all()
    assert (got.float() - want.float()).abs().max().item() < 2e-2
    with pytest.raises(ValueError, match="n_splits"):
        (decode_attention(q, k, v, kv_len, kv_start, n_splits=6) if fmt == "bf16"
         else decode_attention_fusedkv(q, kv, kv_len, kv_start, sc, n_splits=6))


def test_decode_attention_shared_scratch(dev):
    """The partials' scratch kept per stream: calls of growing and shrinking
    size in turn, and a call captured in a CUDA graph and replayed, give
    the bits of a lone eager call of the same shape."""
    from bitdance_tpu_torch.ops.decode_attention import decode_attention

    g = torch.Generator(device=dev).manual_seed(6)

    def case(b, L):
        q = torch.randn((b, 16, 8, 128), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((b, 2, L, 128), generator=g, device=dev).bfloat16()
                for _ in range(2))
        kv_len = torch.full((b,), L - 3, dtype=torch.int32, device=dev)
        kv_start = torch.zeros((b,), dtype=torch.int32, device=dev)
        return lambda: decode_attention(q, k, v, kv_len, kv_start)  # noqa: E731

    small, large = case(2, 200), case(6, 900)
    with torch.no_grad():
        want_small, want_large = small().clone(), large().clone()
        got = [small(), large(), small(), large()]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            large()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = large()
        small()                               # eager use of the cached scratch
        graph.replay()
    torch.cuda.synchronize()
    for out, want in zip(got, [want_small, want_large] * 2):
        assert torch.equal(out, want)
    assert torch.equal(captured, want_large)


def _quant_sampler_case(dev, quant, ch_latent, parallel_num, attention=True, head_dim=128,
                        seed=5):
    """A random quantized head's sampler at one image's rows (2 parallel_num
    rows in 2 windows), 4 steps: (kernel, plain version, the stack)."""
    from bitdance_tpu_torch.io.random_init import init_head
    from bitdance_tpu_torch.ops.fused_head import (
        em_precompute,
        fused_em_sample,
        fused_em_sample_reference,
    )

    g = torch.Generator(device=dev).manual_seed(seed)
    head = init_head(dict(ch_target=32, ch_cond=256, ch_latent=ch_latent,
                          depth_latent=2, depth_adanln=2, parallel_num=parallel_num,
                          attention=attention, use_swiglu=attention, attn_head_dim=head_dim,
                          sample_weight_quant=True if quant == "int8" else "int4"),
                     dev, torch.bfloat16, g)
    s = head._stack_for_sampler()
    assert s["w1"].dtype == torch.int8 and "w1_s" in s
    rows = 2 * parallel_num
    cond = torch.randn((rows, 256), generator=g, device=dev)
    c_emb = cond @ s["cond_w"].float().t() + s["cond_b"]
    t_all = torch.linspace(0.0, 0.95, 5)
    dt_all = torch.cat([t_all[1:] - t_all[:-1], torch.zeros(1)])
    mods = em_precompute(s, c_emb, t_all)
    x0 = torch.randn((rows // 2, 32), generator=g, device=dev)
    noise = torch.randn((4, rows // 2, 32), generator=g, device=dev)
    kw = dict(num_blocks=2, num_ada=2, n_head=ch_latent // head_dim, groups=2 if attention else 1,
              attention=attention, bounded=attention, quant=quant)
    n = fused_em_sample.launches
    with torch.no_grad():
        got = fused_em_sample(s, x0, noise, mods, t_all, dt_all, 3.0, **kw)
        want = fused_em_sample_reference(s, x0, noise, mods, t_all, dt_all, 3.0, **kw)
    torch.cuda.synchronize()
    assert fused_em_sample.launches == n + 1
    return got, want, s


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_sampler_kernel_quant(dev, quant):
    """K3: kernel #2's W8A8 / W4A8 mode vs its plain version on a head whose
    quantized stack the router sends to #2 (C 3072, H 4608, 2 blocks: 80 MB
    a block in int8, 40 MB in int4; smaller quantized heads take the round
    route since R3): the same integer products up to rounding flips of the
    int8 activations."""
    from bitdance_tpu_torch.ops.fused_head import rounds_residual

    got, want, s = _quant_sampler_case(dev, quant, 3072, 64)
    assert not rounds_residual(s, 2, True)
    rel = (got - want).abs().max() / want.abs().max()
    assert torch.isfinite(got).all() and rel.item() < 5e-2


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("family", ["mlp", "trans"])
def test_sampler_kernel_quant_round_route(dev, family, quant):
    """The round route's quant modes (#3/#4 with a quantized stack, R3): a
    small MlpEncoder (C 256, 64 rows) and TransEncoder (C 256, head dim 64,
    2 windows of 16) vs the plain version, the bf16 samplers' bound."""
    from bitdance_tpu_torch.ops.fused_head import rounds_residual

    attention = family == "trans"
    got, want, s = _quant_sampler_case(dev, quant, 256, 16 if attention else 32, attention,
                                       head_dim=64, seed=6)
    assert rounds_residual(s, 2, attention)
    rel = (got - want).abs().max() / want.abs().max()
    assert torch.isfinite(got).all() and rel.item() < 5e-2


@pytest.mark.parametrize("mode", ["bias", "gated_f32", "swiglu_q", "gated", "swiglu_round",
                                  "out_s32"])
@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_head_gemm_s8_kernel(dev, quant, mode):
    """The quant modes' integer products on the head GEMM vs their plain
    twin, bit for bit, at 1, 2 and 4 splits and bm 64 / 128 (64 and 100
    rows; K 1024 and, int4, a half last stage at K 384): kernel #2's modes
    and the round route's ("gated" on a residual of bf16 values)."""
    from bitdance_tpu_torch.ops.fused_head import (
        head_gemm_plan,
        head_gemm_s8,
        head_gemm_s8_split_plain,
        head_gemm_stages,
    )
    from bitdance_tpu_torch.ops.int4 import quantize_linear_int4
    from bitdance_tpu_torch.ops.int8 import quantize_linear, quantize_rows

    g = torch.Generator(device=dev).manual_seed(7)
    for rows, n, k in ((64, 256, 1024), (100, 512, 384)):
        aq, sa = quantize_rows(torch.randn((rows, k), generator=g, device=dev))
        wf = torch.randn((n, k), generator=g, device=dev) / k ** 0.5
        qt = quantize_linear_int4(wf) if quant == "int4" else quantize_linear(wf)
        bias = (0.1 * torch.randn(n, generator=g, device=dev)).bfloat16()
        kw = {}
        if mode.startswith("gated"):
            kw = {"resid": torch.randn((rows, n), generator=g, device=dev),
                  "gate": torch.randn((rows, n), generator=g, device=dev).bfloat16()}
            if mode == "gated":
                kw["resid"] = kw["resid"].bfloat16().float()
        plan = head_gemm_plan(rows, n, k, quant=quant)
        n0 = head_gemm_s8.launches
        for splits in (1, 2, 4):
            if splits > head_gemm_stages(k, quant):
                continue
            fresh = {q: v.clone() if q == "resid" else v for q, v in kw.items()}
            got = head_gemm_s8(aq, sa, qt.q, qt.s, mode, bias, quant=quant,
                               plan=plan._replace(splits=splits), **fresh)
            want = head_gemm_s8_split_plain(aq, sa, qt.q, qt.s, mode, bias, splits=splits,
                                            quant=quant, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (rows, k, splits)
        assert head_gemm_s8.launches > n0


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_head_gemm_s8_out_s32_at_a_ranks_shapes(dev, quant):
    """The tensor-parallel head's raw int32 sums ("out_s32") at a tp-2
    rank's shapes of the 14B head (R 128; qkv and w1 [7680, 5120], wo
    [5120, 2560], w2 [5120, 3840]) bit-equal to the twin at the planned
    split, at 1 and at the most splits; a K stage off by one (the rows
    rolled by 128 columns) moves the twin's sums."""
    from bitdance_tpu_torch.ops.fused_head import (
        HEAD_GEMM_MAX_SPLITS,
        head_gemm_plan,
        head_gemm_s8,
        head_gemm_s8_split_plain,
        head_gemm_stages,
    )

    g = torch.Generator(device=dev).manual_seed(11)
    packed = quant == "int4"
    for n, k in ((7680, 5120), (5120, 2560), (5120, 3840)):
        aq = torch.randint(-127, 128, (128, k), generator=g, device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k // 2 if packed else k), generator=g, device=dev,
                          dtype=torch.int8)
        plan = head_gemm_plan(128, n, k, quant=quant)
        top = min(HEAD_GEMM_MAX_SPLITS, head_gemm_stages(k, quant))
        want = None
        for splits in sorted({plan.splits, 1, 1 << (top.bit_length() - 1)}):
            got = head_gemm_s8(aq, None, w, None, "out_s32", None, quant=quant,
                               plan=plan._replace(splits=splits))
            want = head_gemm_s8_split_plain(aq, None, w, None, "out_s32", None, splits=splits,
                                            quant=quant)
            torch.cuda.synchronize()
            assert got.dtype == torch.int32 and torch.equal(got, want), (n, k, splits)
        moved = head_gemm_s8_split_plain(aq.roll(128, 1), None, w, None, "out_s32", None,
                                         quant=quant)
        assert (moved != want).float().mean().item() > 0.5


@pytest.mark.parametrize("hq,hkv,d,lens", [(10, 2, 128, (70, 150, 230, 40)),
                                           (4, 4, 64, (200, 330, 90))])
def test_flash_sparse_kernels(dev, hq, hkv, d, lens):
    """#10-#12 vs their plain versions over the same tile lists, and equal
    to the dense kernels (#7-#9) on the same inputs."""
    from bitdance_tpu_torch.ops.attention import (
        flash_bwd_dkv,
        flash_bwd_dkv_sparse,
        flash_bwd_dq,
        flash_bwd_dq_sparse,
        flash_fwd,
        flash_fwd_sparse,
        flash_sparse_dkv_reference,
        flash_sparse_dq_reference,
        flash_sparse_reference,
        live_tile_bound,
        sparse_plan,
    )

    g = torch.Generator(device=dev).manual_seed(1)
    blk = torch.arange(sum(lens), device=dev, dtype=torch.int32)[None]
    doc = torch.cat([torch.full((n,), i, device=dev, dtype=torch.int32)
                     for i, n in enumerate(lens)])[None]
    ids = (blk, doc, blk, doc)
    L = blk.shape[1]
    q, do = (torch.randn((1, L, hq, d), generator=g, device=dev).bfloat16() for _ in "ab")
    k, v = (torch.randn((1, L, hkv, d), generator=g, device=dev).bfloat16() for _ in "ab")
    plan = sparse_plan(*ids, live_tile_bound(max(lens)))
    sc = d ** -0.5
    counts = (flash_fwd_sparse.launches, flash_bwd_dq_sparse.launches,
              flash_bwd_dkv_sparse.launches)
    o, lse = flash_fwd_sparse(q, k, v, *ids, plan, sc)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = flash_bwd_dq_sparse(q, k, v, do, lse, delta, *ids, plan, sc)
    dk, dv = flash_bwd_dkv_sparse(q, k, v, do, lse, delta, *ids, plan, sc)
    assert (flash_fwd_sparse.launches, flash_bwd_dq_sparse.launches,
            flash_bwd_dkv_sparse.launches) == tuple(c + 1 for c in counts)
    o_ref, lse_ref = flash_sparse_reference(q, k, v, *ids, plan.kv_map, plan.kv_counts,
                                            sc, return_lse=True)
    dq_ref = flash_sparse_dq_reference(q, k, v, do, lse, delta, *ids, plan.kv_map,
                                       plan.kv_counts, sc)
    dk_ref, dv_ref = flash_sparse_dkv_reference(q, k, v, do, lse, delta, *ids, plan.q_map,
                                                plan.q_counts, plan.block_q_dkv, sc)
    rel = lambda a, b: ((a.float() - b.float()).abs().max()  # noqa: E731
                        / b.float().abs().max()).item()
    for got, want in ((o, o_ref), (dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert rel(got, want) < 1.5e-2
    assert rel(lse, lse_ref) < 1e-6
    assert torch.equal(o, flash_fwd(q, k, v, *ids, sc)[0])
    assert torch.equal(dq, flash_bwd_dq(q, k, v, do, lse, delta, *ids, sc))
    assert all(torch.equal(a, b) for a, b in zip(
        (dk, dv), flash_bwd_dkv(q, k, v, do, lse, delta, *ids, sc)))


@pytest.mark.parametrize("shape,dtype", [((8, 16, 16, 1024), torch.bfloat16),
                                         ((2, 64, 64, 1024), torch.float32),
                                         ((3, 5, 7, 256), torch.bfloat16),
                                         ((1, 9, 11, 64), torch.float32)])
def test_fused_encode_tail_kernel(dev, shape, dtype):
    """#13 vs its plain version: raw output within a few output ulps, ±1
    exact wherever the plain raw value clears the 1e-3 sign margin; two
    launches bit-equal (the statistics' partials summed in a fixed order)."""
    from bitdance_tpu_torch.ops.fused_encode import (
        fused_encode_tail,
        fused_encode_tail_reference,
    )

    g = torch.Generator(device=dev).manual_seed(2)
    c = shape[-1]
    x = (1.5 * torch.randn(shape, generator=g, device=dev) + 0.3).to(dtype)
    gw = 1 + 0.2 * torch.randn(c, generator=g, device=dev)
    gb = 0.2 * torch.randn(c, generator=g, device=dev)
    w = (torch.randn((c, 32), generator=g, device=dev) / c ** 0.5).to(dtype)
    b = 0.1 * torch.randn(32, generator=g, device=dev)
    n = fused_encode_tail.launches
    raw = fused_encode_tail(x, gw, gb, w, b, quantize=False)
    again = fused_encode_tail(x, gw, gb, w, b, quantize=False)
    sgn = fused_encode_tail(x, gw, gb, w, b)
    assert fused_encode_tail.launches == n + 3
    assert torch.equal(raw, again)
    ref = fused_encode_tail_reference(x, gw, gb, w, b, quantize=False)
    bound = 1.6e-2 if dtype == torch.bfloat16 else 1e-5
    assert ((raw.float() - ref.float()).abs().max() / ref.float().abs().max()).item() < bound
    clear = ref.float().abs() > 1e-3
    assert set(sgn.unique().tolist()) <= {-1.0, 1.0}
    assert (sgn == torch.where(ref > 0, 1.0, -1.0).to(sgn.dtype))[clear].all()


BLOCK_BOUND = {False: 3e-5, True: 1.5e-4}


@pytest.mark.parametrize("attention", [False, True], ids=["mlp", "trans"])
def test_fused_diffnet_forward_kernel(dev, attention):
    """Kernel #5 (one whole net call) vs its plain version, small heads of
    both families: the whole net's max error relative to max |plain|, then
    each block run alone, whose mean error relative to mean |plain| must
    stay under a bound that the plain twin with fp32 qkv and h12 (the
    per-call blocks' rounding) exceeds. Bounds: a few times the H100
    readings (NVIDIA H100 80GB HBM3, 700 W; mlp: whole 3.8e-4, per block
    3.3e-6 against the twin's 8.9e-4; trans: whole 2.0e-3, per block 3.2e-5
    against 1.2e-3). An fp32 stack on the card raises."""
    from bitdance_tpu_torch.io.random_init import init_head
    from bitdance_tpu_torch.ops.fused_head import (
        _ATTN_KEYS,
        _MLP_KEYS,
        fused_diffnet_forward,
        fused_diffnet_forward_reference,
    )

    g = torch.Generator(device=dev).manual_seed(4)
    head = init_head(dict(ch_target=16, ch_cond=256, ch_latent=256, depth_latent=4,
                          depth_adanln=2, attention=attention, attn_head_dim=64,
                          parallel_num=16, bounded_output=attention),
                     dev, torch.bfloat16, g)
    s = head._stack_for_sampler()
    lead = (6, 16) if attention else (40,)
    x = torch.randn((*lead, 16), generator=g, device=dev)
    t = torch.rand(lead, generator=g, device=dev)
    c_emb = torch.randn((*lead, 256), generator=g, device=dev)
    kw = dict(num_blocks=4, num_ada=2, n_head=4 if attention else 0,
              attention=attention, bounded=attention)
    n = fused_diffnet_forward.launches
    with torch.no_grad():
        got = fused_diffnet_forward(s, x, t, c_emb, **kw)
        want = fused_diffnet_forward_reference(s, x, t, c_emb, **kw)
    assert fused_diffnet_forward.launches == n + 1
    assert got.shape == x.shape and got.dtype == x.dtype
    rel = (got - want).abs().max() / want.abs().max()
    assert rel.item() < (6e-3 if attention else 1.5e-3)
    keys = list(_MLP_KEYS) + (list(_ATTN_KEYS) if attention else [])
    one = dict(kw, num_blocks=1)
    gap = lambda a, b: ((a - b).abs().mean() / b.abs().mean()).item()  # noqa: E731
    kern, twin = [], []
    with torch.no_grad():
        for l in range(4):
            st = dict(s, **{k: s[k][l:l + 1] for k in keys})
            want = fused_diffnet_forward_reference(st, x, t, c_emb, **one)
            kern.append(gap(fused_diffnet_forward(st, x, t, c_emb, **one), want))
            twin.append(gap(fused_diffnet_forward_reference(
                st, x, t, c_emb, fp32_qkv_h12=True, **one), want))
    bound = BLOCK_BOUND[attention]
    assert sum(kern) / 4 < bound < sum(twin) / 4, (kern, twin)
    f32 = {k: v.float() if v.dtype == torch.bfloat16 else v for k, v in s.items()}
    with pytest.raises(ValueError, match="bfloat16"):
        fused_diffnet_forward(f32, x, t, c_emb, **kw)


# the sampler's head GEMM: (rows, N, K, mode) at the round route's H-1x and
# B-16x products (#3/#4), a ragged small one, and kernel #2's 14B products at
# 128 rows (and w1 at 256) with its fp32-residual epilogues
HEAD_GEMM_CASES = {"h1x_w1": (64, 3840, 1280, "swiglu"), "h1x_w2": (64, 1280, 1920, "gated"),
                   "b16x_qkv": (1024, 2304, 768, "bias"), "b16x_w2": (1024, 768, 1152, "gated"),
                   "ragged_w1": (24, 768, 256, "swiglu"),
                   "t2i_qkv": (128, 15360, 5120, "bias"), "t2i_wo": (128, 5120, 5120, "gated_f32"),
                   "t2i_w1": (128, 15360, 5120, "swiglu_f32"),
                   "t2i_w2": (128, 5120, 7680, "gated_f32"),
                   "t2i_w1_256": (256, 15360, 5120, "swiglu_f32"),
                   # the MLP block #14 at H-1x's 8 rows and B-16x's 512, #5's
                   # fp32 products (an adaLN group's at H-1x, t_w0 at B-16x)
                   "h1x_mlp_w1": (8, 3840, 1280, "swiglu_h32"),
                   "h1x_mlp_w2": (8, 1280, 1920, "gated_bf16"),
                   "b16x_mlp_w1": (512, 2304, 768, "swiglu_h32"),
                   "b16x_mlp_w2": (512, 768, 1152, "gated_bf16"),
                   "h1x_net_mods": (8, 3840, 1280, "out_f32"),
                   "b16x_net_t_w0": (512, 768, 256, "out_f32"),
                   # the attention block #15 at B-16x's 512 and 1024 rows
                   "b16x_attn_qkv": (512, 2304, 768, "bias_f32"),
                   "b16x_attn_qkv_1024": (1024, 2304, 768, "bias_f32"),
                   "b16x_attn_wo": (512, 768, 768, "gated_bf16")}
# kernel vs its split twin on the same splits, max |error| / max |twin|; the
# sums differ in fp32 order only, so an output moves by one bf16 ulp where it
# sits at a rounding boundary: at most 2^-7 of the largest output (twice that
# for the swiglu's product of two rounded halves); gated_f32 and out_f32
# keep fp32, a few fp32 ulps of sums over K 256-7680, as #15's bias_f32;
# #14's swiglu_h32 and gated_bf16 round their output once
HEAD_GEMM_TEST_BOUND = {"bias": 8e-3, "gated": 8e-3, "swiglu": 1.6e-2, "gated_f32": 1e-4,
                        "swiglu_f32": 1.6e-2, "swiglu_h32": 8e-3, "gated_bf16": 8e-3,
                        "out_f32": 1e-4, "bias_f32": 1e-4}


def _head_gemm_inputs(dev, rows, n, k, mode, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((rows, k), generator=g, device=dev).bfloat16()
    w = (torch.randn((n, k), generator=g, device=dev) / k ** 0.5).bfloat16()
    bias = (0.1 * torch.randn((n,), generator=g, device=dev)).bfloat16()
    kw = {}
    if mode in ("gated", "gated_f32"):
        kw["resid"] = torch.randn((rows, n), generator=g, device=dev).bfloat16().float()
    if mode == "gated_bf16":
        kw["x"] = torch.randn((rows, n), generator=g, device=dev).bfloat16()
    if mode.startswith("gated"):
        kw["gate"] = (0.5 * torch.randn((rows, 2 * n), generator=g, device=dev)).bfloat16()[:, n:]
    return a, w, None if mode == "out_f32" else bias, kw


@pytest.mark.parametrize("name", list(HEAD_GEMM_CASES))
def test_head_gemm_kernel(dev, name):
    """Each mode at its planned split count (and at one split) against the
    split twin; two launches bit-equal."""
    from bitdance_tpu_torch.ops.fused_head import (
        head_gemm,
        head_gemm_plan,
        head_gemm_split_plain,
    )

    rows, n, k, mode = HEAD_GEMM_CASES[name]
    a, w, bias, kw = _head_gemm_inputs(dev, rows, n, k, mode, 7)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = head_gemm_plan(rows, n, k, sms)
    before = head_gemm.launches

    def run(**extra):     # "gated" updates its residual in place: a fresh copy
        fresh = {k: v.clone() if k == "resid" else v for k, v in kw.items()}
        return head_gemm(a, w, mode, bias, **fresh, **extra)

    with torch.no_grad():
        for p in {plan, plan._replace(splits=1)}:
            got, again = run(plan=p), run(plan=p)
            want = head_gemm_split_plain(a, w, mode, bias, splits=p.splits, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, again)
            rel = ((got.float() - want.float()).abs().max()
                   / want.float().abs().max()).item()
            assert rel < HEAD_GEMM_TEST_BOUND[mode], (p, rel)
    assert head_gemm.launches > before


def test_head_gemm_refuses_shapes(dev):
    from bitdance_tpu_torch.ops.fused_head import head_gemm

    a = torch.zeros((64, 96), device=dev, dtype=torch.bfloat16)     # K % 64
    w = torch.zeros((128, 96), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        head_gemm(a, w, "bias", torch.zeros(128, device=dev, dtype=torch.bfloat16))


@pytest.mark.parametrize("m", [1, 5, 16, 17, 64])
def test_int_dot_pads_few_rows_onto_int_mm(dev, m):
    """int_dot on the card: 1-16 rows padded to torch._int_mm's 17 give the
    exact integer sums (the float64 sum of the same int8 operands)."""
    from bitdance_tpu_torch.ops.int8 import int_dot

    g = torch.Generator(device=dev).manual_seed(m)
    a = torch.randint(-127, 128, (m, 512), generator=g, device=dev, dtype=torch.int8)
    w = torch.randint(-127, 128, (1000, 512), generator=g, device=dev, dtype=torch.int8)
    got = int_dot(a, w)
    assert got.dtype == torch.float32 and got.shape == (m, 1000)
    assert torch.equal(got, (a.double() @ w.double().t()).float())
