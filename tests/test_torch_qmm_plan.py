"""The dequant-GEMM's launch plan (``dynamo_tpu_torch/ops/qmm.py``), on the
CPU: the body, the tile and the split of the contraction that the one plan
gives at the serving shapes, with the card's resident CTAs as a parameter,
and the workspace the launch allocates (``prepare_call`` on meta tensors:
the 70B shapes allocate nothing)."""

import pytest
import torch

from dynamo_tpu_torch.ops.qmm import (
    DECODE_COLS, DECODE_MAX_M, DECODE_ROWS, DECODE_STEP, MAX_SROWS, MIN_STEPS,
    PREFILL_COLS, PREFILL_ROWS, PREFILL_STEP, make_plan, prepare_call,
    window_rows, workspace_bytes,
)

#: (label, I, O, batch) of the serving shapes: Llama-3-70B, Llama-3-8B and
#: DeepSeek-V2-Lite's routed expert stack
SHAPES = [
    ("70b wq/wo", 8192, 8192, 1), ("70b wk/wv", 8192, 1024, 1),
    ("70b w_gate/w_up", 8192, 28672, 1), ("70b w_down", 28672, 8192, 1),
    ("70b head", 8192, 128256, 1), ("8b wq/wo", 4096, 4096, 1),
    ("8b wk/wv", 4096, 1024, 1), ("8b w_gate/w_up", 4096, 14336, 1),
    ("8b w_down", 14336, 4096, 1), ("8b head", 4096, 128256, 1),
    ("v2-lite experts", 2048, 1408, 64),
]
#: (spec, group size (None: per channel), zero point)
FORMATS = [("int4-g32", 32, False), ("int8", None, False),
           ("int8-g128", 128, True)]
M_VALUES = [1, 2, 7, 8, 9, 16, 17, 31, 32, 33, 64, 65, 128, 129, 512, 1000,
            2048]
#: CTAs the card runs at once (132 SMs x 1, 2 or 4 CTAs an SM)
SLOTS = [132, 264, 528]


def _plan(M, I, O, batch, fmt, slots):
    spec, group, z = fmt
    G = I // group if group else 1
    return make_plan(M, I, O, G, batch=batch, int4=spec.startswith("int4"),
                     z=z, dequant=bool(group) or z, slots=slots)


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("fmt", FORMATS, ids=[f[0] for f in FORMATS])
@pytest.mark.parametrize("label,I,O,batch", SHAPES,
                         ids=[s[0] for s in SHAPES])
def test_plan_body_tile_and_split_cover_the_contraction(label, I, O, batch,
                                                        fmt, slots):
    for M in M_VALUES:
        p = _plan(M, I, O, batch, fmt, slots)
        if M <= DECODE_MAX_M:
            assert p.body == "decode", (label, M)
            assert p.rows == min(r for r in DECODE_ROWS if r >= M)
            assert (p.cols, p.step) == (DECODE_COLS, DECODE_STEP)
        else:
            assert p.body == "prefill", (label, M)
            assert p.rows == min([r for r in PREFILL_ROWS if r >= M]
                                 or PREFILL_ROWS[-1:])
            assert (p.cols, p.step) == (PREFILL_COLS, PREFILL_STEP)
        # the splits cover the contraction exactly once, none empty
        nk = -(-I // p.step)
        assert p.splits >= 1 and p.kps >= 1
        assert (p.splits - 1) * p.kps < nk <= p.splits * p.kps, (label, M)
        tiles = -(-O // p.cols) * -(-M // p.rows) * batch
        if p.splits > 1:
            # a split only where the tiles leave the wave short, and then
            # no more CTAs than the wave holds
            assert tiles < slots and tiles * p.splits <= slots
            assert p.kps >= MIN_STEPS
        else:
            assert tiles >= slots or min(slots // tiles,
                                         nk // MIN_STEPS) <= 1
        # the scale window holds every group a k-step touches, or is off
        group = fmt[1]
        if group is None and not fmt[2]:
            assert p.srows == 0
        else:
            need = window_rows(p.step, group)
            assert p.srows == (need if need <= MAX_SROWS[p.body] else 0)


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("label,I,O,batch", SHAPES,
                         ids=[s[0] for s in SHAPES])
def test_workspace_bytes_equal_what_the_launch_allocates(label, I, O, batch,
                                                         slots):
    """``prepare_call`` allocates the output and the workspace as the
    launch would; on meta tensors nothing is stored."""
    for fmt in FORMATS:
        spec, group, z = fmt
        int4 = spec.startswith("int4")
        G = I // group if group else 1
        lead = (batch,) if batch > 1 else ()
        w = {"q": torch.empty((*lead, I // 2 if int4 else I, O),
                              dtype=torch.uint8 if int4 else torch.int8,
                              device="meta"),
             "s": torch.empty((*lead, G, O), device="meta")}
        if z:
            w["z"] = torch.empty((*lead, G, O), device="meta")
        for M in (1, 8, 32, 33, 2048):
            x = torch.empty((M, I), dtype=torch.bfloat16, device="meta")
            call = prepare_call(x, w, slots=slots)
            want = workspace_bytes(M, I, O, G, batch, int4, z,
                                   dequant=bool(group) or z, slots=slots)
            got = 0 if call.ws is None else call.ws.numel() * 4
            assert got == want == call.plan.workspace_bytes(M, O, batch)
            assert call.out.shape == ((batch, M, O) if batch > 1 else (M, O))
            # the plan's fields are the kernel's arguments
            assert call.args[-7:] == (
                {"decode": 0, "prefill": 1}[call.plan.body], call.plan.rows,
                call.plan.cols, call.plan.step, call.plan.srows,
                call.plan.splits, call.plan.kps)


def test_plan_forces_a_body_and_refuses_what_it_cannot():
    p = make_plan(8, 4096, 4096, 128, int4=True, slots=264, body="prefill")
    assert (p.body, p.rows) == ("prefill", PREFILL_ROWS[0])
    with pytest.raises(ValueError, match="decode body takes"):
        make_plan(DECODE_ROWS[-1] + 1, 4096, 4096, 128, slots=264,
                  body="decode")
    with pytest.raises(ValueError, match="no dequant-GEMM body"):
        make_plan(8, 4096, 4096, 128, slots=264, body="gemv")


@pytest.mark.parametrize("step", [32, 64])
def test_window_rows_counts_the_groups_a_step_touches(step):
    for g in range(1, 200):
        worst = max(len({r // g for r in range(k0, k0 + step)})
                    for k0 in range(0, 8 * g * step, step))
        assert window_rows(step, g) >= worst, g
        if g % step == 0 or step % g == 0:
            assert window_rows(step, g) == worst, g
