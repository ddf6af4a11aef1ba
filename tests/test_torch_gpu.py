"""The torch port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips without a CUDA device. Capped cases run on
queries scaled by ``Q_GAIN`` and must fail with the cap off or doubled. The module imports
neither JAX nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.engine.cache import quantize_kv
from dynamo_tpu_torch.ops.flash_prefill import (
    flash_mla_prefill, flash_mla_prefill_paged, flash_mla_prefill_paged_ref,
    flash_mla_prefill_ref, flash_prefill, flash_prefill_ref,
)
from dynamo_tpu_torch.ops.mla_decode import (
    BF16_ROW_RTOL, mla_paged_decode, mla_paged_decode_ref,
)
from dynamo_tpu_torch.ops.paged_attention import (
    paged_attention_decode, paged_attention_decode_ref,
)
from dynamo_tpu_torch.ops.qmm import DECODE_MAX_M
from dynamo_tpu_torch.ops.ragged_attention import (
    ragged_attention_ref, ragged_paged_attention,
)


def make_case(seed, rows, H, KV, hd, bs, W, num_blocks=160, pad_rows=1,
              pad_tokens=3):
    """rows: (q_len, kv_len) each; numpy operands and the real-token
    count."""
    rng = np.random.default_rng(seed)
    kc = rng.standard_normal((num_blocks * bs, KV, hd), np.float32)
    vc = rng.standard_normal((num_blocks * bs, KV, hd), np.float32)
    R = len(rows) + pad_rows
    rows3 = np.zeros((R, 3), np.int32)
    bt = np.zeros((R, W), np.int32)
    t = 0
    for i, (ql, kl) in enumerate(rows):
        rows3[i] = (t, ql, kl)
        used = (kl + bs - 1) // bs
        bt[i, :used] = rng.choice(np.arange(1, num_blocks), size=used,
                                  replace=False)
        t += ql
    q = rng.standard_normal((t + pad_tokens, H, hd), np.float32)
    sinks = rng.standard_normal((H,), np.float32)
    return dict(q=q, kc=kc, vc=vc, bt=bt, rows3=rows3, sinks=sinks), t


#: short rows (one key chunk per tile) and long rows whose tiles split
#: their keys over several CTAs (split-K)
CASES = {
    "short": ([(1, 20), (6, 24), (1, 9), (11, 11), (37, 60)], 4),
    "split": ([(1, 700), (40, 530), (1, 9), (130, 130)], 48),
}


#: Gemma-2's attention logit softcap
SOFTCAP = 50.0
#: capped variants scale q by this: unit q and k give scores of about
#: N(0, 1) after the 1/sqrt(hd) scale, where a cap of 50 moves a score by
#: under 0.01 and no tolerance could tell a kernel with the cap from one
#: without it; at N(0, 144) the top scores reach 30-50, where the cap bends
#: them by units
Q_GAIN = 12.0


def check_capped(kernel, want, tol, cap):
    """``kernel(c)``: the kernel's output at softcap c, cut to its defined
    part. At ``cap`` it must match ``want`` (the plain version's, f32)
    within ``tol``; with a cap, the runs with the cap off and doubled must
    not, so that the case sees the cap."""
    torch.testing.assert_close(kernel(cap).float(), want, atol=tol,
                               rtol=tol)
    for c in ((0.0, 2 * cap) if cap else ()):
        with pytest.raises(AssertionError):
            torch.testing.assert_close(kernel(c).float(), want, atol=tol,
                                       rtol=tol)
#: (window, sinks?, softcap) of each ragged case
RAGGED_VARIANTS = ((0, False, 0.0), (7, True, 0.0), (300, True, 0.0),
                   (0, False, SOFTCAP), (7, True, SOFTCAP))


@pytest.mark.gpu
@pytest.mark.parametrize("case_name", sorted(CASES))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hd", [64, 256])
def test_kernel_matches_plain_on_card(dtype, tol, case_name, hd):
    """The CUDA kernel against the plain version: f32 differs by summation
    order; in bf16 both round the output to 8 mantissa bits and the kernel
    rounds P to bf16 before P.V, a step or two apart. Windows, sinks and
    the logit softcap (on queries scaled by Q_GAIN); head dims 64 and 256
    (Gemma)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rows, W = CASES[case_name]
    case, t = make_case(3, rows, H=8, KV=2, hd=hd, bs=16, W=W)
    args = [torch.from_numpy(case[k]).cuda()
            for k in ("q", "kc", "vc", "bt", "rows3")]
    args[:3] = [a.to(dtype) for a in args[:3]]
    sinks = torch.from_numpy(case["sinks"]).cuda()
    for window, with_sinks, cap in RAGGED_VARIANTS:
        kw = dict(block_size=16, window=window,
                  sinks=sinks if with_sinks else None)
        q = args[0] * Q_GAIN if cap else args[0]
        want = ragged_attention_ref(q, *args[1:], softcap=cap, **kw)
        check_capped(lambda c: ragged_paged_attention(
            q, *args[1:], softcap=c, **kw)[:t], want[:t].float(), tol, cap)


@pytest.mark.gpu
@pytest.mark.parametrize("case_name", sorted(CASES))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hd", [128, 256])
def test_int8_pages_match_plain_on_card(dtype, tol, case_name, hd):
    """int8 pages with per-(slot, head) scales, behind a junk layer that the
    block tables and ``scale_slot_base`` step over. bf16 adds the rounding
    of p * v_scale to bf16 before P.V to the tolerance's two steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rows, W = CASES[case_name]
    case, t = make_case(4, rows, H=8, KV=2, hd=hd, bs=16, W=W)
    kq, ks = quantize_kv(torch.from_numpy(case["kc"]).cuda())
    vq, vs = quantize_kv(torch.from_numpy(case["vc"]).cuda())
    slots = kq.shape[0]
    kq2 = torch.cat([torch.full_like(kq, 7), kq])
    vq2 = torch.cat([torch.full_like(vq, 7), vq])
    q = torch.from_numpy(case["q"]).cuda().to(dtype)
    bt = torch.from_numpy(case["bt"] + slots // 16).cuda()
    rows3 = torch.from_numpy(case["rows3"]).cuda()
    sinks = torch.from_numpy(case["sinks"]).cuda()
    for window, with_sinks, cap in RAGGED_VARIANTS:
        kw = dict(block_size=16, window=window,
                  sinks=sinks if with_sinks else None, k_scales=ks,
                  v_scales=vs, scale_slot_base=slots)
        qc = q * Q_GAIN if cap else q
        want = ragged_attention_ref(qc, kq2, vq2, bt, rows3, softcap=cap,
                                    **kw)
        check_capped(lambda c: ragged_paged_attention(
            qc, kq2, vq2, bt, rows3, softcap=c, **kw)[:t],
            want[:t].float(), tol, cap)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_flash_prefill_matches_plain_on_card(dtype, tol, hd):
    """Causal rows from pos_base > 0 with S < T, a kv_len 0 row, a window
    with sinks, the logit softcap; one geometry splits its keys (few query
    tiles), one does not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    for B, S, H, KV, T, pos_base, kv_lens in (
            (3, 40, 8, 2, 700, (600, 0, 5), (640, 0, 700)),
            (2, 300, 32, 8, 300, (0, 0), (300, 123))):
        def t(*shape):
            return torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).cuda().to(dtype)

        q, k, v = t(B, S, H, hd), t(B, T, KV, hd), t(B, T, KV, hd)
        pb = torch.tensor(pos_base, dtype=torch.int32).cuda()
        kl = torch.tensor(kv_lens, dtype=torch.int32).cuda()
        sinks = torch.from_numpy(rng.standard_normal(H).astype(
            np.float32)).cuda()
        for kw, cap in (({}, 0.0), ({"sliding_window": 33, "sinks": sinks},
                                    0.0),
                        ({}, SOFTCAP),
                        ({"sliding_window": 33, "sinks": sinks}, SOFTCAP)):
            qc = q * Q_GAIN if cap else q
            want = flash_prefill_ref(qc, k, v, pb, kl, softcap=cap, **kw)
            check_capped(lambda c: flash_prefill(qc, k, v, pb, kl,
                                                 softcap=c, **kw),
                         want.float(), tol, cap)


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("H,KV,hd", [(32, 8, 128), (16, 8, 256)])
def test_paged_decode_matches_plain_on_card(dtype, tol, quant, H, KV, hd):
    """The paged decode contract on the ragged kernel: one query per row at
    the Llama-3-8B and the Gemma-2-9B head geometries, a kv_len 0 row, a
    one-page row and a row long enough to split its keys; window and sinks,
    and the logit softcap; int8 pages behind a junk layer that the tables
    and ``scale_slot_base`` step over."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kv_lens = [0, 16, 1057, 2900, 333]
    rows = [(1, max(k, 1)) for k in kv_lens]
    case, _ = make_case(7, rows, H=H, KV=KV, hd=hd, bs=16, W=192,
                        num_blocks=600, pad_rows=0, pad_tokens=0)
    q = torch.from_numpy(case["q"]).cuda().to(dtype)
    kc = torch.from_numpy(case["kc"]).cuda()
    vc = torch.from_numpy(case["vc"]).cuda()
    bt = torch.from_numpy(case["bt"]).cuda()
    kl = torch.tensor(kv_lens, dtype=torch.int32).cuda()
    sinks = torch.from_numpy(case["sinks"]).cuda()
    kw = {}
    if quant:
        kq, ks = quantize_kv(kc)
        vq, vs = quantize_kv(vc)
        slots = kq.shape[0]
        kc = torch.cat([torch.full_like(kq, 7), kq])
        vc = torch.cat([torch.full_like(vq, 7), vq])
        bt = bt + slots // 16
        kw = dict(k_scales=ks, v_scales=vs, scale_slot_base=slots)
    else:
        kc, vc = kc.to(dtype), vc.to(dtype)
    for window, sk, cap in ((None, None, 0.0), (100, sinks, 0.0),
                            (100, sinks, SOFTCAP)):
        qc = q * Q_GAIN if cap else q
        run = dict(block_size=16, window=window, sinks=sk, **kw)
        want = paged_attention_decode_ref(qc, kc, vc, bt, kl, softcap=cap,
                                          **run)
        check_capped(lambda c: paged_attention_decode(
            qc, kc, vc, bt, kl, softcap=c, **run), want.float(), tol, cap)
        got = paged_attention_decode(qc, kc, vc, bt, kl, softcap=cap, **run)
        assert not got[0].float().any()  # kv_len 0: zeros


def mla_pages(rng, nb, bs, R, PR, dtype):
    """Latent and rope pages of nb blocks on the card, and the kwargs that
    go with them: int8 pages quantized per slot and stream, behind a junk
    layer that the returned table offset and ``scale_slot_base`` step
    over."""
    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda()

    lat, rope = t(nb * bs, R), t(nb * bs, PR)
    if dtype != torch.int8:
        return lat.to(dtype), rope.to(dtype), 0, {}
    cq, cs = quantize_kv(lat[:, None])
    rq, rs = quantize_kv(rope[:, None])
    slots = nb * bs
    return (torch.cat([torch.full_like(cq[:, 0], 7), cq[:, 0]]),
            torch.cat([torch.full_like(rq[:, 0], 7), rq[:, 0]]), nb,
            dict(c_scales=cs, r_scales=rs, scale_slot_base=slots))


def assert_mla_close(got, want, dtype):
    """f32 within 1e-4; bf16 and int8 pages (q and P rounded to fp16 for
    the tensor cores) each row within BF16_ROW_RTOL of its own largest
    magnitude, the limit chip_smoke.py holds the kernels to; a row of zeros
    (no visible key) exactly zeros."""
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        return
    err = (got - want).abs().flatten(1).amax(1)
    scale = want.abs().flatten(1).amax(1)
    assert bool((err <= BF16_ROW_RTOL * scale).all()), (err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("geometry", [(16, 512, 128), (32, 128, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_mla_decode_matches_plain_on_card(dtype, geometry):
    """The MLA latent-decode kernel against its plain version: the
    DeepSeek-V2-Lite geometry (H = 16, R = 512, PR = 128) and one with two head
    tiles; a kv_len 0 row, a one-page row and long rows split over many
    CTAs; f32, bf16 and int8 pages (the int8 scale table rebased)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    H, R, PR = geometry
    rng = np.random.default_rng(H + R)
    bs, nb, W = 16, 700, 256
    kv_lens = [0, 16, 3000, 65, 1500, 9]
    bt = np.zeros((len(kv_lens), W), np.int32)
    for b, n in enumerate(kv_lens):
        used = -(-n // bs)
        bt[b, :used] = rng.choice(np.arange(1, nb), used, replace=False)
    q_eff = torch.from_numpy(rng.standard_normal(
        (len(kv_lens), H, R)).astype(np.float32)).cuda()
    q_rot = torch.from_numpy(rng.standard_normal(
        (len(kv_lens), H, PR)).astype(np.float32)).cuda()
    lat, rope, off, kw = mla_pages(rng, nb, bs, R, PR, dtype)
    args = (q_eff, q_rot, lat, rope, torch.from_numpy(bt + off).cuda(),
            torch.tensor(kv_lens, dtype=torch.int32).cuda())
    got = mla_paged_decode(*args, block_size=bs, scale=0.0722, **kw)
    want = mla_paged_decode_ref(*args, block_size=bs, scale=0.0722, **kw)
    assert_mla_close(got, want, dtype)
    assert not got[0].any()  # kv_len 0: zeros


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_mla_prefill_matches_plain_on_card(dtype):
    """The MLA flash-prefill kernel against its plain versions, paged and
    dense: chunks deep into their context (pos_base > 0, S < T), a kv_len 0
    row, a row whose last query tile straddles kv_len (S not a multiple of
    the tile), a fresh causal row; the DeepSeek-V2-Lite geometry and one
    with two head tiles; int8 pages with a rebased scale table."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(11)
    bs, nb = 16, 400
    for H, R, PR in ((16, 512, 128), (32, 128, 64)):
        B, S, W = 4, 38, 160
        pos_base = [600, 0, 0, 37]
        kv_lens = [638, 0, 30, 75]  # row 2: kv_len inside its last tiles
        bt = np.zeros((B, W), np.int32)
        for b, n in enumerate(kv_lens):
            used = -(-n // bs)
            bt[b, :used] = rng.choice(np.arange(1, nb), used, replace=False)

        def t(*shape):
            return torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).cuda()

        q_eff, q_rot = t(B, S, H, R), t(B, S, H, PR)
        lat, rope, off, kw = mla_pages(rng, nb, bs, R, PR, dtype)
        pb = torch.tensor(pos_base, dtype=torch.int32).cuda()
        kl = torch.tensor(kv_lens, dtype=torch.int32).cuda()
        args = (q_eff, q_rot, lat, rope, torch.from_numpy(bt + off).cuda(),
                pb, kl)
        got = flash_mla_prefill_paged(*args, block_size=bs, scale=0.0722,
                                      **kw)
        want = flash_mla_prefill_paged_ref(*args, block_size=bs,
                                           scale=0.0722, **kw)
        assert_mla_close(got.flatten(0, 1), want.flatten(0, 1), dtype)
        assert not got[1].any()  # kv_len 0: zeros
        if dtype == torch.int8:
            continue
        # the dense entry: T keys per row, no table
        T = 700
        c, kr = t(B, T, R).to(dtype), t(B, T, PR).to(dtype)
        got = flash_mla_prefill(q_eff, q_rot, c, kr, pb, kl, scale=0.0722)
        want = flash_mla_prefill_ref(q_eff, q_rot, c, kr, pb, kl,
                                     scale=0.0722)
        assert_mla_close(got.flatten(0, 1), want.flatten(0, 1), dtype)


# ------------------------------------------------ tile edges of the wgmma body
#
# The bf16 body attends query tiles of 64 rows a warpgroup (64/G tokens; the
# dense kernel two warpgroups) over key tiles of 64 keys. These cases put
# every edge inside a tile: query and key counts that are not multiples of
# either, a window edge inside a key tile, rows that see no key, one key, a
# page and a half, group sizes 1 to 16, and tiles that split their keys
# beside tiles that do not, in one launch.

#: (q_len, kv_len): a row that sees no key, one key, a page, a page and one,
#: a decode row long enough to split, a fresh prefill of 45 tokens, a chunk
#: of 37 at kv 1300, 3 tokens at kv 64, 70 at kv 200
EDGE_ROWS = [(1, 0), (1, 1), (1, 16), (1, 17), (1, 2000), (45, 45),
             (37, 1300), (3, 64), (70, 200)]


@pytest.mark.gpu
@pytest.mark.parametrize("pages", ["bf16", "int8"])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 2, 4, 7, 8, 16])
def test_ragged_tile_edges_on_card(G, hd, pages):
    """The ragged kernel on bf16 queries at every tile edge (EDGE_ROWS),
    without and with a window of 100 (an edge inside a key tile) and sinks,
    and with the logit softcap; int8 pages behind a junk layer that the
    tables and ``scale_slot_base`` step over. G 7 (Qwen2-7B) fills 63 of
    the 64 query rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    KV = 2
    case, t = make_case(20 + G + hd, EDGE_ROWS, H=G * KV, KV=KV, hd=hd,
                        bs=16, W=128, num_blocks=400, pad_rows=2,
                        pad_tokens=5)
    q = torch.from_numpy(case["q"]).cuda().to(torch.bfloat16)
    kc = torch.from_numpy(case["kc"]).cuda()
    vc = torch.from_numpy(case["vc"]).cuda()
    bt = torch.from_numpy(case["bt"]).cuda()
    rows3 = torch.from_numpy(case["rows3"]).cuda()
    sinks = torch.from_numpy(case["sinks"]).cuda()
    kw = {}
    if pages == "int8":
        kq, ks = quantize_kv(kc)
        vq, vs = quantize_kv(vc)
        slots = kq.shape[0]
        kc = torch.cat([torch.full_like(kq, 7), kq])
        vc = torch.cat([torch.full_like(vq, 7), vq])
        bt = bt + slots // 16
        kw = dict(k_scales=ks, v_scales=vs, scale_slot_base=slots)
    else:
        kc, vc = kc.to(torch.bfloat16), vc.to(torch.bfloat16)
    for window, sk, cap in ((0, None, 0.0), (100, sinks, 0.0),
                            (100, sinks, SOFTCAP)):
        qc = q * Q_GAIN if cap else q
        run = dict(block_size=16, window=window, sinks=sk, **kw)
        want = ragged_attention_ref(qc, kc, vc, bt, rows3, softcap=cap,
                                    **run)
        check_capped(lambda c: ragged_paged_attention(
            qc, kc, vc, bt, rows3, softcap=c, **run)[:t],
            want[:t].float(), 2e-2, cap)
        got = ragged_paged_attention(qc, kc, vc, bt, rows3, softcap=cap,
                                     **run)
        assert not got[0].float().any()  # the row that sees no key: zeros


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 4, 8, 16])
def test_flash_prefill_tile_edges_on_card(G, hd):
    """Flash prefill in bf16 with S = 45 tokens (not a multiple of any query
    tile) over T = 300 keys: a fresh row, a chunk at pos_base 255, a kv_len
    0 row, a row whose kv_len 131 ends inside a key tile below its last
    queries; no window, and a window of 100 with sinks. Few query tiles, so
    the keys split; then 2 rows of 1100 tokens at G = 4 whose tiles do not
    split."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(30 + G + hd)
    geometries = [(4, 45, G * 2, 2, 300, (0, 255, 0, 100), (45, 300, 0, 131))]
    if G == 4:
        geometries.append((2, 1100, 32, 8, 1100, (0, 0), (1100, 777)))
    for B, S, H, KV, T, pos_base, kv_lens in geometries:
        def t(*shape):
            return torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).cuda().to(torch.bfloat16)

        q, k, v = t(B, S, H, hd), t(B, T, KV, hd), t(B, T, KV, hd)
        pb = torch.tensor(pos_base, dtype=torch.int32).cuda()
        kl = torch.tensor(kv_lens, dtype=torch.int32).cuda()
        sinks = torch.from_numpy(rng.standard_normal(H).astype(
            np.float32)).cuda()
        for kw, cap in (({}, 0.0),
                        ({"sliding_window": 100, "sinks": sinks}, 0.0),
                        ({"sliding_window": 100, "sinks": sinks}, SOFTCAP)):
            qc = q * Q_GAIN if cap else q
            want = flash_prefill_ref(qc, k, v, pb, kl, softcap=cap, **kw)
            check_capped(lambda c: flash_prefill(qc, k, v, pb, kl,
                                                 softcap=c, **kw),
                         want.float(), 2e-2, cap)
            got = flash_prefill(qc, k, v, pb, kl, softcap=cap, **kw)
        if B == 4:
            assert not got[2].float().any()  # kv_len 0: zeros


@pytest.mark.gpu
@pytest.mark.parametrize("pages", ["bf16", "int8"])
@pytest.mark.parametrize("G", [1, 4, 8, 16])
def test_paged_decode_tile_edges_on_card(G, pages):
    """The paged decode contract (B4) at kv 1, at page boundaries (16, 32,
    64, one past them) and at kv 0, hd 128, with a window of 17 and sinks;
    int8 pages with a rebased scale table."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kv_lens = [1, 16, 17, 32, 33, 64, 65, 0, 1000]
    KV = 2
    case, _ = make_case(40 + G, [(1, max(k, 1)) for k in kv_lens],
                        H=G * KV, KV=KV, hd=128, bs=16, W=64,
                        num_blocks=200, pad_rows=0, pad_tokens=0)
    q = torch.from_numpy(case["q"]).cuda().to(torch.bfloat16)
    kc = torch.from_numpy(case["kc"]).cuda()
    vc = torch.from_numpy(case["vc"]).cuda()
    bt = torch.from_numpy(case["bt"]).cuda()
    kl = torch.tensor(kv_lens, dtype=torch.int32).cuda()
    sinks = torch.from_numpy(case["sinks"]).cuda()
    kw = {}
    if pages == "int8":
        kq, ks = quantize_kv(kc)
        vq, vs = quantize_kv(vc)
        slots = kq.shape[0]
        kc = torch.cat([torch.full_like(kq, 7), kq])
        vc = torch.cat([torch.full_like(vq, 7), vq])
        bt = bt + slots // 16
        kw = dict(k_scales=ks, v_scales=vs, scale_slot_base=slots)
    else:
        kc, vc = kc.to(torch.bfloat16), vc.to(torch.bfloat16)
    for window, sk in ((None, None), (17, sinks)):
        got = paged_attention_decode(q, kc, vc, bt, kl, block_size=16,
                                     window=window, sinks=sk, **kw)
        want = paged_attention_decode_ref(q, kc, vc, bt, kl, block_size=16,
                                          window=window, sinks=sk, **kw)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
        assert not got[7].float().any()  # kv_len 0: zeros


# ------------------------------------------ tile edges of the MLA wgmma body
#
# The MLA bf16/int8 body attends 4 tokens x 16 heads (64 rows) a CTA over
# key tiles of 64 keys (32 when R + q_rot's width exceed 576), two
# warpgroups each taking half of a tile's scores and half of the output's
# columns; decode rows split their keys over CTAs by the table width.

#: MLA decode kv_lens: no key, one key, around a 64-key tile (63, 64, 65),
#: a page and one, two tiles and two keys, and rows long enough to split
#: beside rows that do not, in one launch
MLA_EDGE_KV = [0, 1, 17, 63, 64, 65, 130, 2000, 3000]
#: MLA prefill rows (pos_base, kv_len) of S = 45 tokens (not a multiple of
#: the 4-token query tile): a fresh row of 45 keys, a chunk deep into its
#: context, a row that sees no key, a row whose kv_len 131 ends inside its
#: query tiles (tokens 31-44 past it), a row that sees one key
MLA_EDGE_PREFILL = [(0, 45), (255, 300), (0, 0), (100, 131), (0, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("live", [None, 64])
@pytest.mark.parametrize("pages", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("geometry", [(16, 512, 128), (32, 128, 64),
                                      (16, 192, 64), (16, 64, 128)])
def test_mla_tile_edges_on_card(geometry, pages, live):
    """MLA decode (B5/B5b) and MLA prefill (B3m, paged and dense) at every
    tile edge of the wgmma body (MLA_EDGE_KV, MLA_EDGE_PREFILL): one and
    two head tiles; R 512 / PR 128, R 128 / PR 64, and the latent ranks
    that split the output's 64-column blocks unevenly over the two
    warpgroups (R 192: two and one; R 64: one and none); bf16 pages and
    int8 pages behind a rebased scale table. With ``live`` q_rot is that
    narrow while the rope pages' columns past it are nonzero: the kernel
    must equal the plain version on q_rot zero-padded to the pages' width.
    Without it q_rot has the pages' whole width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    H, R, PR = geometry
    rng = np.random.default_rng(60 + H + R + (live or 0))
    bs, nb, W = 16, 700, 256
    lat, rope, off, kw = mla_pages(rng, nb, bs, R, PR, pages)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda()

    def zero_pad(q_rot):
        return torch.nn.functional.pad(q_rot, (0, PR - q_rot.shape[-1]))

    def table(kv_lens):
        bt = np.zeros((len(kv_lens), W), np.int32)
        for b, n in enumerate(kv_lens):
            used = -(-n // bs)
            bt[b, :used] = rng.choice(np.arange(1, nb), used, replace=False)
        return torch.from_numpy(bt + off).cuda()

    B = len(MLA_EDGE_KV)
    q_eff, q_rot = t(B, H, R), t(B, H, live or PR)
    bt = table(MLA_EDGE_KV)
    kl = torch.tensor(MLA_EDGE_KV, dtype=torch.int32).cuda()
    got = mla_paged_decode(q_eff, q_rot, lat, rope, bt, kl, block_size=bs,
                           scale=0.0722, **kw)
    want = mla_paged_decode_ref(q_eff, zero_pad(q_rot), lat, rope, bt, kl,
                                block_size=bs, scale=0.0722, **kw)
    assert_mla_close(got, want, pages)
    assert not got[0].any()  # kv_len 0: zeros

    S = 45
    B = len(MLA_EDGE_PREFILL)
    q_eff, q_rot = t(B, S, H, R), t(B, S, H, live or PR)
    pb = torch.tensor([p for p, _ in MLA_EDGE_PREFILL],
                      dtype=torch.int32).cuda()
    kl = torch.tensor([k for _, k in MLA_EDGE_PREFILL],
                      dtype=torch.int32).cuda()
    bt = table([k for _, k in MLA_EDGE_PREFILL])
    got = flash_mla_prefill_paged(q_eff, q_rot, lat, rope, bt, pb, kl,
                                  block_size=bs, scale=0.0722, **kw)
    want = flash_mla_prefill_paged_ref(q_eff, zero_pad(q_rot), lat, rope, bt,
                                       pb, kl, block_size=bs, scale=0.0722,
                                       **kw)
    assert_mla_close(got.flatten(0, 1), want.flatten(0, 1), pages)
    assert not got[2].any()  # kv_len 0: zeros
    if pages == torch.int8:
        return
    # the dense entry: T keys a row, no table
    T = 300
    c, kr = t(B, T, R).to(pages), t(B, T, PR).to(pages)
    got = flash_mla_prefill(q_eff, q_rot, c, kr, pb, kl, scale=0.0722)
    want = flash_mla_prefill_ref(q_eff, zero_pad(q_rot), c, kr, pb, kl,
                                 scale=0.0722)
    assert_mla_close(got.flatten(0, 1), want.flatten(0, 1), pages)


@pytest.mark.gpu
@pytest.mark.parametrize("magnitude", ["large", "small"])
@pytest.mark.parametrize("pages", [torch.bfloat16, torch.int8])
def test_mla_fp16_range_on_card(pages, magnitude):
    """The MLA wgmma body takes fp16 operands, whose range (6.1e-5 to
    65504 at full precision) is narrower than the f32 queries' and the
    bf16 pages': queries of magnitude ~4e5 and pages of ~1e5 (large), or
    queries of ~4e-5 and pages of ~4e-4 (small, with int8 c scales of
    ~3e-6), with the softmax scale set so the scores are of order one.
    Decode (B5/B5b) and prefill (B3m) must equal their plain versions
    within BF16_ROW_RTOL, row by row, with no inf or NaN."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    H, R, PR = 16, 512, 128
    aq, ak = (1e5, 3e4) if magnitude == "large" else (1e-5, 1e-4)
    rng = np.random.default_rng(90)
    bs, nb, W = 16, 300, 128
    lat, rope = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32) * ak).cuda() for shape in ((nb * bs, R), (nb * bs, PR)))
    rope[:, 64:] = 0
    kw = {}
    if pages == torch.int8:
        cq, cs = quantize_kv(lat[:, None])
        rq, rs = quantize_kv(rope[:, None])
        lat, rope = cq[:, 0], rq[:, 0]
        kw = dict(c_scales=cs, r_scales=rs)
    else:
        lat, rope = lat.to(pages), rope.to(pages)
    scale = 0.0722 / (aq * ak)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * aq).cuda()

    kv_lens = [1, 65, 700, 2000]
    bt = np.zeros((len(kv_lens), W), np.int32)
    for b, n in enumerate(kv_lens):
        used = -(-n // bs)
        bt[b, :used] = rng.choice(np.arange(1, nb), used, replace=False)
    bt = torch.from_numpy(bt).cuda()
    kl = torch.tensor(kv_lens, dtype=torch.int32).cuda()
    q_eff, q_rot = t(len(kv_lens), H, R), t(len(kv_lens), H, 64)
    got = mla_paged_decode(q_eff, q_rot, lat, rope, bt, kl, block_size=bs,
                           scale=scale, **kw)
    want = mla_paged_decode_ref(q_eff, q_rot, lat, rope, bt, kl,
                                block_size=bs, scale=scale, **kw)
    assert bool(got.isfinite().all())
    assert_mla_close(got, want, pages)

    S = 40
    pb = torch.tensor([0, 25, 660, 1960], dtype=torch.int32).cuda()
    q_eff, q_rot = t(len(kv_lens), S, H, R), t(len(kv_lens), S, H, 64)
    got = flash_mla_prefill_paged(q_eff, q_rot, lat, rope, bt, pb, kl,
                                  block_size=bs, scale=scale, **kw)
    want = flash_mla_prefill_paged_ref(q_eff, q_rot, lat, rope, bt, pb, kl,
                                       block_size=bs, scale=scale, **kw)
    assert bool(got.isfinite().all())
    assert_mla_close(got.flatten(0, 1), want.flatten(0, 1), pages)


@pytest.mark.gpu
@pytest.mark.parametrize("V", [1, 7, 1023, 1024, 1025, 4095, 4096, 4097,
                               32000, 128256])
def test_gumbel_argmax_matches_plain_on_card(V):
    """The draw kernel's tokens equal its plain version's on the card:
    vocabulary widths across the kernel's 1024-element chunk edges, rows
    with top-k/top-p style cuts and a row whose every entry is masked but
    one; a zero-logit row (the noise alone decides) and keys at the uint32
    edges. Twice: each launch leaves its arrival counters at 0 for the
    next."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dynamo_tpu_torch.ops.sample import gumbel_argmax, gumbel_argmax_ref

    rng = np.random.default_rng(V)
    B = 6
    lg = torch.from_numpy((rng.standard_normal((B, V)) * 2).astype(
        np.float32)).cuda()
    lg[4] = 0.0
    temp = torch.tensor([0.5, 1.0, 1.3, 1e-6, 0.8, 1.0], device="cuda")
    x = lg / temp[:, None]
    cut = torch.full((B,), float("-inf"), device="cuda")
    cut[1] = x[1].max()  # one token left
    cut[2] = x[2].topk(min(5, V)).values[-1]
    seed = torch.tensor([0, 1, 2**31 - 1, -1, 12345, 7], dtype=torch.int32,
                        device="cuda")
    step = torch.tensor([0, -1, 5, 2**31 - 1, 77, 128], dtype=torch.int32,
                        device="cuda")
    want = gumbel_argmax_ref(lg, temp, cut, seed, step)
    for _ in range(2):
        got = gumbel_argmax(lg, temp, cut, seed, step)
        torch.cuda.synchronize()
        assert got.tolist() == want.tolist()
    assert gumbel_argmax.launches > 0


@pytest.mark.gpu
def test_sampler_on_card_draws_with_the_kernel():
    """``engine.sampling.sample`` on CUDA logits launches the draw for a
    batch with sampled rows (never for an all-greedy one) and gives the
    plain path's tokens on the same logits moved to the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dynamo_tpu_torch.engine import sampling
    from dynamo_tpu_torch.ops.sample import gumbel_argmax

    rng = np.random.default_rng(3)
    B, V = 8, 50000
    lg = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    temp = np.asarray([0, 0.6, 0.8, 1.0, 1.2, 0.7, 0.9, 1.1], np.float32)
    top_k = np.asarray([0, 0, 40, 0, 64, 0, 5, 0], np.int32)
    top_p = np.asarray([1, 1, 1, 0.9, 1, 0.5, 1, 0.95], np.float32)
    keys = sampling.make_keys(range(B), range(100, 100 + B))
    n0 = gumbel_argmax.launches
    tc, lc = sampling.sample(torch.from_numpy(lg).cuda(), temp, top_k,
                             top_p, keys)
    assert gumbel_argmax.launches == n0 + 1
    sampling.sample(torch.from_numpy(lg).cuda(), np.zeros(B, np.float32),
                    top_k, top_p, keys)
    assert gumbel_argmax.launches == n0 + 1
    tp, lp = sampling.sample(torch.from_numpy(lg), temp, top_k, top_p, keys)
    assert tc.tolist() == tp.tolist()
    np.testing.assert_allclose(lc.cpu().numpy(), lp.numpy(), atol=1e-5)


# --------------------------------------------------------- captured steps


def _graph_engine(kind: str, guided_vocab=None, **knobs):
    """A small engine on the card whose steps the kernels take: GQA (hd
    64, group 4) with bf16 or int8 KV, or MLA + MoE (H 16, rank 64);
    ``knobs`` are further EngineArgs."""
    from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
    from dynamo_tpu_torch.engine.engine import AsyncTorchEngine

    if kind == "mla_bf16":
        cfg = ModelConfig(
            vocab_size=512, hidden_size=128, intermediate_size=256,
            num_layers=2, num_heads=16, num_kv_heads=16, dtype="bfloat16",
            max_position_embeddings=4096, kv_lora_rank=64,
            q_lora_rank=None, qk_nope_head_dim=16, qk_rope_head_dim=64,
            v_head_dim=16, num_experts=8, num_experts_per_tok=2,
            moe_intermediate_size=64, n_shared_experts=1,
            first_k_dense_replace=1)
    else:
        cfg = ModelConfig(
            vocab_size=512, hidden_size=256, intermediate_size=512,
            num_layers=2, num_heads=8, num_kv_heads=2, head_dim=64,
            max_position_embeddings=4096, dtype="bfloat16")
    args = EngineArgs(**{**dict(
        block_size=16, num_blocks=512, max_num_seqs=8,
        max_num_batched_tokens=256, max_model_len=1024,
        kv_cache_dtype="int8" if kind == "gqa_int8" else None), **knobs})
    return AsyncTorchEngine(cfg, args, guided_vocab=guided_vocab)


def _seq(engine, rng, n, sampling=None):
    from dynamo_tpu_torch.engine.scheduler import SeqState
    from dynamo_tpu_torch.protocols import (
        PreprocessedRequest, SamplingOptions,
    )

    s = SeqState(request_id="g", req=PreprocessedRequest(
        model="x", token_ids=[1], sampling_options=sampling
        or SamplingOptions()), ctx=None, sink=None)
    s.tokens = list(map(int, rng.integers(0, engine.cfg.vocab_size, n)))
    s.step_idx = n
    s.block_table = engine.pool.allocate(-(-(n + 4) // 16))
    return s


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["gqa_bf16", "gqa_int8", "mla_bf16"])
def test_captured_steps_equal_eager_on_card(kind):
    """A decode-only and a mixed step, captured in that order, then run
    eagerly, their written slots zeroed, and replayed in a shuffled order
    (mixed, decode, decode, mixed): logits and every written cache slot
    bit-equal to the eager step's, and each replay counts the eager
    step's kernel launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dynamo_tpu_torch.engine.graphs import COUNTED
    from dynamo_tpu_torch.engine.scheduler import PrefillWork, StepPlan

    engine = _graph_engine(kind)
    rng = np.random.default_rng(5)
    a, b, c = (_seq(engine, rng, n) for n in (301, 180, 40))
    plans = {"decode": (StepPlan(decode=[_seq(engine, rng, int(n)) for n in
                                         rng.integers(100, 300, 8)]), False),
             "mixed": (StepPlan(prefill=[PrefillWork(b, 100, 80, True),
                                         PrefillWork(c, 0, 40, True)],
                                decode=[a]), True)}
    ops, slots = {}, {}
    for name, (plan, _) in plans.items():
        ops[name], _ = engine.pack(plan)
        n = len(plan.decode) + sum(w.chunk for w in plan.prefill)
        slots[name] = torch.from_numpy(
            ops[name][0][2, :n].astype(np.int64)).cuda()
    leaves = [t for cache in (engine.k_cache, engine.v_cache)
              for t in (cache.values() if isinstance(cache, dict)
                        else (cache,))]

    def forward(name):
        R = ops[name][1].shape[0]
        ints5, rows3, grid, bt = engine._staging.put(
            [np.zeros((5, R), np.int32), np.zeros((R,), np.int32),
             *ops[name]])[2:]
        before = [w.launches for w in COUNTED]
        logits = engine._forward(ints5, rows3,
                                 grid if plans[name][1] else None,
                                 bt).clone()
        torch.cuda.synchronize()
        return (logits, [t[:, slots[name]].clone() for t in leaves],
                [w.launches - n for w, n in zip(COUNTED, before)])

    for name in plans:
        forward(name)  # first use and capture
    assert len(engine.graphs) == 2
    engine.use_graphs = False
    want = {name: forward(name) for name in plans}
    for name in plans:
        for t in leaves:
            t[:, slots[name]] = 0
    engine.use_graphs = True
    for name in ("mixed", "decode", "decode", "mixed"):
        got = forward(name)
        assert torch.equal(got[0], want[name][0]), name
        assert all(torch.equal(g, w) for g, w in zip(got[1], want[name][1]))
        assert got[2] == want[name][2] and any(got[2]), name


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["gqa_bf16", "gqa_int8", "mla_bf16"])
def test_swap_round_trip_on_card(kind):
    """Preempt-to-swap under graphs on the pipelined loop: eight requests
    on a pool of half their working set swap victims out and back; each
    victim's blocks (``blocks_digest``) are bit-equal before its swap-out
    and after its swap-in, nothing recomputes, and after close() no host
    byte stays reserved and no block stays counted swapped."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import asyncio

    from chip_smoke import SwapSpy  # the card phase's digest spy
    from dynamo_tpu_torch.protocols import (
        PreprocessedRequest, StopConditions,
    )

    n, isl, osl = 8, 200, 64
    working = n * -(-(isl + osl) // 16)
    engine = _graph_engine(kind, num_blocks=working // 2 + 1)
    assert engine.use_graphs and engine.args.pipeline_decode
    spy = SwapSpy(engine)
    rng = np.random.default_rng(7)

    async def run():
        async def one(p):
            toks = []
            async for o in engine.generate(PreprocessedRequest(
                    model="x", token_ids=p, stop_conditions=StopConditions(
                        max_tokens=osl, ignore_eos=True))):
                toks += o.token_ids
            return toks

        try:
            return await asyncio.gather(*(one(list(map(int, rng.integers(
                0, engine.cfg.vocab_size, isl)))) for _ in range(n)))
        finally:
            await engine.close()

    streams = asyncio.run(run())
    st = engine.swap_stats()
    assert all(len(t) == osl for t in streams)
    assert st["preempt_swap"] > 0 and st["preempt_recompute"] == 0
    assert st["swap_out_blocks"] == st["swap_in_blocks"] > 0
    assert st["swapped_blocks"] == 0 and st["swap_host_bytes"] == 0
    assert spy.check(kind) == st["preempt_swap"]


@pytest.mark.gpu
def test_burst_graph_equals_captured_single_steps_on_card():
    """A K = 3 burst replayed from its graph gives the tokens of three
    single decode steps replayed from theirs (each fed the previous one's
    tokens on the card), greedy and seeded rows together."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dynamo_tpu_torch.engine.cache import NULL_BLOCK
    from dynamo_tpu_torch.protocols import SamplingOptions

    engine = _graph_engine("gqa_bf16")
    rng = np.random.default_rng(9)
    seqs = [_seq(engine, rng, int(n), SamplingOptions(
        temperature=0.8, top_k=20, seed=i) if i % 2 else None)
        for i, n in enumerate(rng.integers(50, 200, 6))]
    R = engine.args.ragged_rows(engine.args.bucket_ragged_tokens(len(seqs)))
    pad = [None] * (R - len(seqs))

    def singles():
        toks, feed = [], None
        for off in range(3):
            out = engine._step(engine._decode_operands(seqs, off), False,
                               feed, engine._sampling_plan(seqs + pad, off))
            feed = out["toks"][:len(seqs)]
            out["copied"].synchronize()
            toks.append(out["host"][0].tolist()[:len(seqs)])
        return toks

    W = engine.args.max_blocks_per_seq
    ints3 = np.zeros((3, R), np.int32)
    bt = np.full((R, W), NULL_BLOCK, np.int32)
    for i, s in enumerate(seqs):
        ints3[:, i] = (s.tokens[-1], len(s.tokens) - 1, len(s.tokens))
        bt[i, :len(s.block_table)] = s.block_table

    def burst():
        out = engine._burst(ints3, bt, engine._sampling_plan(seqs + pad), 3)
        out["copied"].synchronize()
        return [row[:len(seqs)] for row in out["host"][0].tolist()]

    first = singles()  # eager first use, capture
    assert singles() == first  # replays
    assert burst() == first  # eager first use, capture
    assert burst() == first  # replay
    assert engine.compile_events["multi"] == 1  # one capture, one replay


# ------------------------------------------------------ speculative decoding

#: the full-width step rule of chip_smoke.py: logits within this share of
#: their largest magnitude (the kernels round P to bf16 before P.V)
STEP_RTOL = 0.05


def _verify_case(engine, rng, K=4):
    """Verify operands of 6 rows at kv 100-300, each [newest token, K
    draft tokens] (the last row's draft shorter, padded with 0), and the
    slots they write."""
    bs = engine.args.block_size
    rows = []
    for i, n in enumerate(rng.integers(100, 300, 6)):
        s = _seq(engine, rng, int(n))
        base = len(s.tokens) - 1
        d = list(map(int, rng.integers(0, engine.cfg.vocab_size,
                                       K if i < 5 else 2)))
        rows.append(([s.tokens[-1]] + d + [0] * (K - len(d)), base,
                     [s.block_table[p // bs] * bs + p % bs
                      for p in range(base, base + K + 1)],
                     len(s.tokens) + K, s.block_table))
    from dynamo_tpu_torch.engine.engine import verify_bucket
    T = verify_bucket(engine.args, len(rows), K + 1)
    ops = engine._verify_operands(rows, T)
    n = len(rows) * (K + 1)
    return ops, torch.from_numpy(ops[0][2, :n].astype(np.int64)).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("kind,masked", [("gqa_bf16", False),
                                         ("gqa_bf16", True),
                                         ("gqa_int8", False),
                                         ("mla_bf16", False)])
def test_captured_verify_equals_eager_on_card(kind, masked):
    """A verify step (6 rows of K + 1 = 5 tokens), captured, then run
    eagerly, its written slots zeroed, and replayed twice: the rows' ids
    and logprobs and every written cache slot bit-equal to the eager
    run's, and each replay counts the eager run's kernel launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dynamo_tpu_torch.engine.graphs import COUNTED

    engine = _graph_engine(kind, speculative_tokens=4)
    ops, slots = _verify_case(engine, np.random.default_rng(17))
    T = ops[0].shape[1]
    mw = None
    if masked:
        rng = np.random.default_rng(3)
        mw = rng.integers(0, 2**32, (T, -(-engine.cfg.vocab_size // 32)),
                          dtype=np.uint64).astype(np.uint32).view(np.int32)
    leaves = [t for cache in (engine.k_cache, engine.v_cache)
              for t in (cache.values() if isinstance(cache, dict)
                        else (cache,))]

    n = slots.shape[0]

    def verify():
        before = [w.launches for w in COUNTED]
        out = engine._verify(ops, mw)
        out["copied"].synchronize()
        # the rows' positions: a padding token's output is unspecified
        return ([t[:n].clone() for t in out["host"]],
                [t[:, slots].clone() for t in leaves],
                [w.launches - n for w, n in zip(COUNTED, before)])

    verify()  # first use and capture
    key = ("verify_fsm" if masked else "verify", T)
    assert key in engine.graphs
    engine.use_graphs = False
    want = verify()
    for t in leaves:
        t[:, slots] = 0
    engine.use_graphs = True
    for _ in range(2):
        got = verify()
        assert all(torch.equal(g, w) for g, w in zip(got[0], want[0]))
        assert all(torch.equal(g, w) for g, w in zip(got[1], want[1]))
        assert got[2] == want[2] and any(got[2])
    assert engine.compile_events[key[0]] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["gqa_bf16", "gqa_int8", "mla_bf16"])
def test_verify_through_kernels_matches_plain_on_card(kind):
    """The verify step through the kernels (B1/B2 for GQA, B3m for MLA's
    chunk tokens) against the same step through their plain versions:
    the logits of every packed position within STEP_RTOL of their scale,
    and the argmax equal at every position but bf16 ties (the plain
    logits of the two picks within one bf16 step at the logit scale)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import math

    from dynamo_tpu_torch.engine.model import (
        make_ragged_verify_fn, mla_attention_seg,
    )

    engine = _graph_engine(kind, speculative_tokens=4)
    cfg, bs = engine.cfg, engine.args.block_size
    ops, _ = _verify_case(engine, np.random.default_rng(23))
    T = ops[0].shape[1]
    n = 6 * 5
    tensors = [torch.from_numpy(a).cuda() for a in ops]
    plain = (make_ragged_verify_fn(cfg, bs, attention=mla_paged_decode_ref,
                                   chunk_attention=mla_attention_seg)
             if cfg.is_mla else
             make_ragged_verify_fn(cfg, bs, attention=ragged_attention_ref))
    outs = []
    for fn in (plain, make_ragged_verify_fn(cfg, bs)):
        buf = torch.empty((T, cfg.vocab_size), dtype=torch.float32,
                          device="cuda")
        before = (ragged_paged_attention.launches,
                  flash_mla_prefill_paged.launches,
                  mla_paged_decode.launches)
        ids, _, _, _ = fn(engine.params, *tensors, engine.k_cache,
                          engine.v_cache, logits_out=buf)
        torch.cuda.synchronize()
        after = (ragged_paged_attention.launches,
                 flash_mla_prefill_paged.launches,
                 mla_paged_decode.launches)
        outs.append((buf[:n].clone(), ids[:n].clone(),
                     [a - b for a, b in zip(after, before)]))
    (want, want_ids, plain_l), (got, got_ids, kern_l) = outs
    L = cfg.num_layers
    assert plain_l == [0, 0, 0]
    # MLA: the chunk kernel for the rows, and the latent-decode call as the
    # step makes it (no row has q_len 1, so each sees kv_len 0)
    assert kern_l == ([0, L, L] if cfg.is_mla else [L, 0, 0])
    assert bool(torch.isfinite(got).all())
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= STEP_RTOL * scale
    ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
    gap = want.max(-1).values - want.gather(1, got_ids[:, None].long())[:, 0]
    same = got_ids == want_ids
    assert bool((same | (gap <= ulp)).all()), (same, gap)


@pytest.mark.gpu
def test_draft_graph_equals_eager_on_card():
    """The layer-skip draft burst (D = 1 of 2 layers, K = 4) replayed from
    its graph gives the eager burst's tokens, and the D x K ragged
    launches a burst."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dynamo_tpu_torch.engine.cache import NULL_BLOCK

    engine = _graph_engine("gqa_bf16", speculative_tokens=4,
                           speculative_method="draft_layers",
                           speculative_draft_layers=1)
    rng = np.random.default_rng(31)
    seqs = [_seq(engine, rng, int(n)) for n in rng.integers(50, 200, 6)]
    R = engine.args.ragged_rows(engine.args.bucket_ragged_tokens(len(seqs)))
    W = engine.args.max_blocks_per_seq
    ints3 = np.zeros((3, R), np.int32)
    bt = np.full((R, W), NULL_BLOCK, np.int32)
    for i, s in enumerate(seqs):
        ints3[:, i] = (s.tokens[-1], len(s.tokens) - 1, len(s.tokens))
        bt[i, :len(s.block_table)] = s.block_table

    def draft():
        before = ragged_paged_attention.launches
        out = engine._draft(ints3, bt, 4)
        out["copied"].synchronize()
        return ([row[:len(seqs)] for row in out["host"][0].tolist()],
                ragged_paged_attention.launches - before)

    first = draft()  # eager first use, capture
    engine.use_graphs = False
    eager = draft()
    engine.use_graphs = True
    assert draft() == eager == first
    assert first[1] == 4  # D x K
    assert engine.compile_events["draft"] == 1


@pytest.mark.gpu
def test_fsm_arena_update_seen_by_replay_on_card():
    """The FSM sampler is captured while one constraint's rows are in the
    arena; a second constraint placed afterwards lands in the same arena
    tensors, and the next replay masks its row with the new rows: its
    token is one the new constraint allows, and equals the eager step's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dynamo_tpu_torch.structured import build_guided_state

    vocab = [""] + [chr(32 + i) for i in range(511)]
    engine = _graph_engine("gqa_bf16", guided_vocab=vocab)
    assert engine.structured is not None
    rng = np.random.default_rng(2)
    seqs = [_seq(engine, rng, 60 + i) for i in range(4)]
    ops = engine._decode_operands(seqs, 0)
    R = ops[1].shape[0]
    pad = [None] * (R - len(seqs))

    def step(graphs):
        engine.use_graphs = graphs
        out = engine._step(ops, False, None,
                           engine._sampling_plan(seqs + pad))
        out["copied"].synchronize()
        return out["host"][0].tolist()[0]

    seqs[0].guided_state = build_guided_state(
        {"regex": "[ab]+"}, vocab, [2], engine.structured, True)
    mask_before = engine.structured.device_tables()[0]
    assert vocab[step(True)] in "ab"  # first use, capture
    assert vocab[step(True)] in "ab"  # replay
    seqs[0].guided_state = build_guided_state(
        {"regex": "[xyz]+"}, vocab, [2], engine.structured, True)
    assert engine.structured.device_tables()[0] is mask_before
    got = step(True)  # replay with the new rows
    assert vocab[got] in "xyz"
    assert got == step(False)


#: the consumer process of ``test_direct_ipc_pull_by_another_process``:
#: once up, it waits for the descriptor in argv[1], pulls it, copies the
#: tensors into its own memory (the scatter's read), releases, and saves
#: them to argv[2]
IPC_CONSUMER = """
import asyncio, os, sys, time, torch
from dynamo_tpu_torch.disagg.transfer import (
    DirectTransferManager, KvDirectFrame, pull_bundle)
from dynamo_tpu_torch.runtime.codec import unpackb
mgr = DirectTransferManager(device="cuda")
print(mgr.capability(), flush=True)
while not os.path.exists(sys.argv[1]):
    time.sleep(0.001)
frame = KvDirectFrame.from_wire(unpackb(open(sys.argv[1], "rb").read()))
b = pull_bundle(mgr, frame)
k, v = b.k.clone(), b.v.clone()
mapped = mgr.ipc.mapped
asyncio.run(mgr.release(b))
torch.save((k.cpu(), v.cpu()), sys.argv[2])
print(mapped, mgr.ipc.mapped, mgr.stats["pulls"], flush=True)
"""


@pytest.mark.gpu
def test_direct_ipc_pull_by_another_process(tmp_path):
    """An "ipc" offer of two tensors on the card (one a view at an offset
    into a larger allocation, as a layer group is), the second written
    behind a second of device work, pulled by another process at once: it
    reads the written bytes (its stream waited for the producer's event),
    maps one handle a segment and unmaps them at release; the offer is
    then freed on the producer, and ``choose_mode`` picks "ipc" for that
    process's capability."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import os
    import pathlib
    import subprocess
    import sys

    from dynamo_tpu_torch.disagg.transfer import (
        DirectTransferManager, KvDirectFrame,
    )
    from dynamo_tpu_torch.runtime.codec import packb

    path, out = tmp_path / "desc.bin", tmp_path / "kv.pt"
    root = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.Popen([sys.executable, "-c", IPC_CONSUMER, str(path),
                             str(out)], cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    mgr = DirectTransferManager(device="cuda")
    try:
        cap = proc.stdout.readline().strip()
        assert mgr.choose_mode([cap]) == "ipc", proc.stderr.read()[-3000:]
        g = torch.Generator(device="cuda").manual_seed(5)
        big = torch.randn(8, 40, 16, 8, 128, generator=g, device="cuda",
                          dtype=torch.bfloat16)
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000_000)  # about a second of device work
        k = big[4:8]
        v = big[:4] * 2
        desc = mgr.offer("ipc", [k, v], {"num_tokens": 640, "n": 40,
                                         "block_size": 16, "start_block": 0},
                         ready=mgr.ready("ipc"))
        assert desc["arrays"][0]["offset"] > 0
        tmp = path.with_suffix(".tmp")
        tmp.write_bytes(packb(KvDirectFrame(desc).to_wire()))
        os.rename(tmp, path)
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, stderr[-3000:]
        mapped, after, pulls = map(int, stdout.split())
        handles = {bytes(a["handle"]) for a in desc["arrays"]}
        assert (mapped, after, pulls) == (len(handles), 0, 1)
        got_k, got_v = torch.load(out)
        assert torch.equal(got_k, k.cpu()) and torch.equal(got_v, v.cpu())
        assert mgr.outstanding() == 0 and mgr.held_bytes() == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        mgr.close()


# ------------------------------------------------ the dequant-GEMM (qmm.cu)

#: (spec, zero point) of every format the kernel takes
QMM_FORMATS = [("int8", False), ("int8-g128", False), ("int4-g32", False),
               ("int4-g128", False), ("int8-g16", True), ("int4-g16", False)]


def _qweight(spec, lead, I, O, z, seed):
    from dynamo_tpu_torch.engine.quant import parse_spec, quantize

    bits, group = parse_spec(spec)
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = (torch.randn((*lead, I, O), generator=g, device="cuda")
         / I ** 0.5).to(torch.bfloat16)
    qt = quantize(w, bits, group)
    if z:
        qt["z"] = 0.01 * torch.rand(qt["s"].shape, generator=g,
                                    device="cuda")
    return qt


def _qmm_close(got, want, rtol):
    """Each row's largest error within ``rtol`` of the row's largest
    |value| (``ops/qmm.py``'s ROW_RTOL)."""
    got, want = got.float().flatten(0, -2), want.float().flatten(0, -2)
    assert bool(torch.isfinite(got).all())
    err = (got - want).abs().amax(-1)
    scale = want.abs().amax(-1)
    assert bool((err <= rtol * scale).all()), (err / scale).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 8, 37, 300])
@pytest.mark.parametrize("I,O", [(512, 1000), (4096, 1024)])
@pytest.mark.parametrize("spec,z", QMM_FORMATS)
def test_quant_matmul_matches_plain_on_card(spec, z, I, O, M):
    """Every format at decode and prefill M, an O that is no multiple of
    128 (nor of 16: the 8-byte loads), and a split contraction."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from dynamo_tpu_torch.ops.qmm import (
        ROW_RTOL, quant_matmul, quant_matmul_ref,
    )

    qt = _qweight(spec, (), I, O, z, seed=M + O)
    g = torch.Generator(device="cuda").manual_seed(M)
    x = torch.randn((M, I), generator=g, device="cuda").to(torch.bfloat16)
    n = quant_matmul.launches
    got = quant_matmul(x, qt)
    want = quant_matmul_ref(x, qt)
    torch.cuda.synchronize()
    assert quant_matmul.launches == n + 1
    assert got.shape == (M, O) and got.dtype == torch.bfloat16
    per_channel = spec == "int8" and not z
    _qmm_close(got, want, ROW_RTOL["per_channel" if per_channel
                                   else "grouped"])
    # no atomics: the same call gives the same bits
    assert torch.equal(quant_matmul(x, qt), got)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [3, 70])
@pytest.mark.parametrize("spec,z", [("int8", False), ("int8-g16", True),
                                    ("int4-g16", False), ("int8-g80", False)])
def test_quant_matmul_partial_contraction_step_on_card(spec, z, M):
    """I = 1040: the last 64-row step is a quarter full; g80 spans two
    scale rows in some steps."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from dynamo_tpu_torch.ops.qmm import (
        ROW_RTOL, quant_matmul, quant_matmul_ref,
    )

    qt = _qweight(spec, (), 1040, 264, z, seed=M)
    x = torch.randn((M, 1040), device="cuda").to(torch.bfloat16)
    got = quant_matmul(x, qt)
    want = quant_matmul_ref(x, qt)
    _qmm_close(got, want, ROW_RTOL["per_channel" if spec == "int8"
                                   else "grouped"])


@pytest.mark.gpu
@pytest.mark.parametrize("shared_x", [True, False])
@pytest.mark.parametrize("spec", ["int8", "int4-g32"])
def test_quant_matmul_batched_on_card(spec, shared_x):
    """The expert-stack form (DeepSeek-V2-Lite's [E, 2048, 1408] at 8
    experts): x shared by every expert, or one x an expert."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from dynamo_tpu_torch.ops.qmm import (
        ROW_RTOL, quant_matmul, quant_matmul_ref,
    )

    E, I, O, M = 8, 2048, 1408, 24
    qt = _qweight(spec, (E,), I, O, False, seed=3)
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((M, I) if shared_x else (E, M, I), generator=g,
                    device="cuda").to(torch.bfloat16)
    got = quant_matmul(x, qt)
    want = quant_matmul_ref(x, qt)
    assert got.shape == (E, M, O)
    _qmm_close(got, want, ROW_RTOL["grouped"])


@pytest.mark.gpu
@pytest.mark.parametrize("spec", ["int8", "int8-g128", "int4-g32"])
def test_quantize_on_card_bit_equal_to_cpu(spec):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from dynamo_tpu_torch.engine.quant import parse_spec, quantize

    bits, group = parse_spec(spec)
    g = torch.Generator(device="cuda").manual_seed(7)
    w = (torch.randn((2, 1024, 768), generator=g, device="cuda")
         * torch.rand((768,), generator=g, device="cuda")).to(torch.bfloat16)
    got = quantize(w, bits, group)
    want = quantize(w.cpu(), bits, group)
    assert torch.equal(got["q"].cpu(), want["q"])
    assert torch.equal(got["s"].cpu(), want["s"])


@pytest.mark.gpu
def test_quant_matmul_refuses_what_it_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from dynamo_tpu_torch.ops.qmm import quant_matmul

    qt = _qweight("int8-g16", (), 64, 40, False, seed=0)
    x = torch.randn((4, 64), device="cuda")
    with pytest.raises(ValueError, match="bf16"):
        quant_matmul(x, qt)  # f32 activations
    with pytest.raises(ValueError, match="bf16"):
        quant_matmul(x.half(), qt)
    xb = x.to(torch.bfloat16)
    bad_i = {"q": torch.zeros((40, 16), dtype=torch.int8, device="cuda"),
             "s": torch.ones((1, 16), device="cuda")}
    with pytest.raises(ValueError, match="I % 16"):
        quant_matmul(torch.zeros((2, 40), dtype=torch.bfloat16,
                                 device="cuda"), bad_i)
    bad_o = {"q": torch.zeros((64, 12), dtype=torch.int8, device="cuda"),
             "s": torch.ones((1, 12), device="cuda")}
    with pytest.raises(ValueError, match="O % 8"):
        quant_matmul(xb, bad_o)
    bad_g = {"q": torch.zeros((64, 16), dtype=torch.int8, device="cuda"),
             "s": torch.ones((3, 16), device="cuda")}
    with pytest.raises(ValueError, match="group count"):
        quant_matmul(xb, bad_g)


def _qmm_check(qt, x, body=None):
    """The kernel (the plan's body, or ``body``) against the plain version
    within ROW_RTOL, and the same call bit-equal on a second run."""
    from dynamo_tpu_torch.ops.qmm import (
        ROW_RTOL, quant_matmul, quant_matmul_ref,
    )

    n = quant_matmul.launches
    got = quant_matmul(x, qt, body=body)
    want = quant_matmul_ref(x, qt)
    torch.cuda.synchronize()
    assert quant_matmul.launches == n + 1
    per_channel = (qt["q"].dim() == 2 and qt["s"].shape[-2] == 1
                   and "z" not in qt)
    _qmm_close(got, want, ROW_RTOL["per_channel" if per_channel
                                   else "grouped"])
    assert torch.equal(quant_matmul(x, qt, body=body), got)


def _qx(M, I, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((M, I), generator=g, device="cuda").to(torch.bfloat16)


#: M at each body and tile boundary: the decode body's row tiles (8, 16,
#: 32), the crossover (DECODE_MAX_M) and one past it, the prefill tile (128)
#: and its half
QMM_EDGE_M = sorted({8, 9, 16, 17, 32, 33, 64, 65, 128, 129, DECODE_MAX_M,
                     DECODE_MAX_M + 1})


@pytest.mark.gpu
@pytest.mark.parametrize("M", QMM_EDGE_M)
@pytest.mark.parametrize("spec,z", [("int4-g32", False), ("int8", False),
                                    ("int8-g128", True)])
def test_quant_matmul_body_boundaries_on_card(spec, z, M):
    """I 2048, O 1032: a partial column tile in both bodies (and no
    multiple of 16: the 8-byte loads), split contractions at decode M."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    qt = _qweight(spec, (), 2048, 1032, z, seed=M)
    _qmm_check(qt, _qx(M, 2048, M + 1))


@pytest.mark.gpu
@pytest.mark.parametrize("M", [8, 2048])
@pytest.mark.parametrize("spec", ["int4-g32", "int8"])
def test_quant_matmul_small_n_split_on_card(spec, M):
    """Llama-3-70B's wk/wv (8192 -> 1024): too few output tiles for a wave
    in either body, so the contraction is split."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from dynamo_tpu_torch.ops.qmm import prepare_call

    qt = _qweight(spec, (), 8192, 1024, False, seed=5)
    x = _qx(M, 8192, 6)
    assert prepare_call(x, qt).plan.splits > 1
    _qmm_check(qt, x)


@pytest.mark.gpu
@pytest.mark.parametrize("spec", ["int4-g32", "int8"])
def test_quant_matmul_prefill_without_split_on_card(spec):
    """2048 rows at 4096 -> 4096: 256 output tiles, no split."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from dynamo_tpu_torch.ops.qmm import prepare_call

    qt = _qweight(spec, (), 4096, 4096, False, seed=7)
    x = _qx(2048, 4096, 8)
    plan = prepare_call(x, qt).plan
    assert plan.body == "prefill" and plan.splits == 1
    _qmm_check(qt, x)


@pytest.mark.gpu
@pytest.mark.parametrize("body", ["decode", "prefill"])
@pytest.mark.parametrize("M", [1, 16])
@pytest.mark.parametrize("spec,z,I", [
    ("int4-g8", False, 1024),    # scales read in place (too many a step)
    ("int8-g4", True, 1024),
    ("int4-g24", True, 1536),    # rows of a thread's step in two groups
    ("int4-g1024", False, 1024),  # int4 per channel: the epilogue scales
])
def test_quant_matmul_each_body_every_window_on_card(spec, z, I, M, body):
    """Each body forced at tiny M, over each way to reach the scales."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    qt = _qweight(spec, (), I, 264, z, seed=I + M)
    _qmm_check(qt, _qx(M, I, M), body=body)
