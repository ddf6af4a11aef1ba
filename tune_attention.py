#!/usr/bin/env python3
"""Where the attention kernels' and the dequant-GEMM's time goes, on one
CUDA card.

    python3 tune_attention.py [--family gqa|mla|qmm|all] [--variant NAME]...
                              [--seed N]
    python3 tune_attention.py --compare DIR [DIR ...]
                              [--family gqa|mla|qmm] [--seed N]
    python3 tune_attention.py --crossover [--seed N]

The first form builds the kernels of a family once for each variant below,
from copies of ``dynamo_tpu_torch/ops/csrc`` in the ignored
``ops/build/tune/`` (one nvcc per library, all started together), and
times each build on the cases of ``chip_smoke.py``'s kernel phase:

- ``gqa`` (``flash_prefill.cu`` and ``ragged_attention.cu`` over
  ``attention_core.cuh``): flash prefill at the Llama-3-8B embeddings
  geometry, the ragged kernel's Llama-3-8B mixed case on bf16 and int8
  pages, its rows alone (the 512-token prefill, the 128-token chunk at kv
  2048, the two decode rows) and eight decode rows;
- ``mla`` (``mla_prefill.cu`` and ``mla_decode.cu`` over
  ``mla_core.cuh``): MLA flash prefill (B3m) on the DeepSeek-V2-Lite chunk
  grid (68 tiles x 32 tokens, bf16 and int8 pages) and a dense 2 x 1024
  prefill, and MLA decode (B5, B5b) at eight rows of kv 73-2582;
- ``qmm`` (``qmm.cu``, the dequant-GEMM): Llama-3-70B's w_gate
  (8192->28672), w_down (28672->8192) and wq (8192->8192) and
  Llama-3-8B's head (4096->128256), each in int4-g32 and int8, at M 8
  and 2048.

Variants:

- ``default``: the sources as they are;
- ``no key copies``: the copies of every key tile after the first left out
  (the kernel computes on stale tiles: its time without the copies);
- ``no tensor-core products``: the matrix instructions of both products
  left out (its time without them);
- (``mla`` only) ``decode chunks of 64+ keys`` and ``of 256+ keys``: MLA
  decode's split-K chunks at least one or four key tiles long in place of
  two; ``no split-K merge`` (MLA decode's merge kernel not launched) and
  ``no query loads`` (Q left zeros): where a short walk's fixed time goes;
  ``no bf16 range check`` (scores not checked for a bf16 value past
  fp16's range), ``no value-scale reference`` (p times a key's value
  scale not divided by the largest so far) and ``no Q row scales``: what
  keeping fp16's range costs when nothing leaves it. Without key copies
  a bf16 tile is converted to fp16 again in place, which leaves values
  past fp16's range, so that variant's bf16 cases time the rescaling
  walk;
- (``qmm`` only, timed only) ``no dequant`` (the quantized bytes go to
  the products as they are, reinterpreted as bf16), ``no q loads`` (no
  weight bytes from device memory: the first kernel's copies
  zero-filled, the redesign's TMA boxes all of the first k-step, from
  L2), ``no scale loads`` and ``no x loads`` (the same for the scales and
  zero points, and for x), ``no split reduce`` (the split contraction's
  partial sums not added); ``no tensor-core products`` leaves out its
  ``mma`` / ``wgmma`` too.
  Each variant holds its edits for the first ``qmm.cu`` (a bf16 tile
  dequantized in shared memory between two barriers) and for the
  redesigned one; the first set whose every text is found applies.

The default build is held against the plain versions with
``chip_smoke``'s tolerances before it is timed (with the SDPA yardstick
beside it); the ablated ones are only timed. The card's name and power
limit come first.

``--crossover`` times both bodies of the dequant-GEMM, forced, on
Llama-3-70B's w_gate (int4-g32 and int8) at M 1 to 64 (the decode body up
to its 16 rows): where the plan's ``DECODE_MAX_M`` comes from.

``--compare`` times the main cases of a family in each checkout DIR in
turn (``--family qmm``: the ``qmm`` cases above, kernel only), each in its
own process with that checkout's ``chip_smoke.py`` and kernels, and
prints one line per run and a table: give a parent and a
change as ``parent change change parent`` to compare them on one card.
The MLA cases (the default, or ``--family mla``): B3m grid and dense, B5,
B5b; the GQA cases (``--family gqa``): the Llama-3-8B embeddings (B3), the
mixed case on bf16 and int8 pages (B1, B2) and eight decode rows, all
uncapped at hd 128, each kernel timed alone (no check, no yardstick: an
older checkout's yardstick builds a cuDNN plan a shape).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.ops.flash_prefill import flash_prefill
from dynamo_tpu_torch.ops.qmm import quant_matmul
from dynamo_tpu_torch.ops.ragged_attention import ragged_paged_attention

NAMES = {"gqa": ("flash_prefill", "ragged_attention"),
         "mla": ("mla_prefill", "mla_decode"), "qmm": ("qmm",)}


class Alt(tuple):
    """Alternative edit lists for one source file: the first whose every
    text is found applies (the same variant on two versions of a kernel).
    """


#: variant: text replacements by source file (none: the default, checked
#: against the plain versions)
VARIANTS = {
    "default": {},
    "no key copies": {
        "attention_core.cuh": [("      load(it + 1, sl);\n", "")],
        "mla_core.cuh": [("          load((it + 1) & 1, slot);\n", "")],
    },
    "no tensor-core products": {
        "qmm.cu": Alt((
            [("mma_bf16(acc[i][j], a[i]", "if (0) mma_bf16(acc[i][j], a[i]"),
             ("mma_bf16(acc[i][j + 1]", "if (0) mma_bf16(acc[i][j + 1]")],
            # the decode body's products replaced by one add that keeps
            # the dequantized registers live
            [("            mma_bf16(acc[2 * c + jj][nt], fr, bx[nt][0], "
              "bx[nt][1]);",
              "            acc[2 * c + jj][nt][0] += __uint_as_float("
              "(fr[0] ^ fr[1] ^ fr[2] ^ fr[3] ^ bx[nt][0]) & 0x3FFFFFFFu);"),
             ("      mma_rs<N>(acc, cur[kk], desc(xa + kk * 32, 16, 1024));",
              "      acc[kk] += __uint_as_float((cur[kk][0] ^ cur[kk][1] ^ "
              "cur[kk][2] ^ cur[kk][3]) & 0x3FFFFFFFu);")],
        )),
        "attention_core.cuh": [
            ("      mma_ss_n64(s,", "      if (0) mma_ss_n64(s,"),
            ("      mma_rs(o, pa[kk]", "      if (0) mma_rs(o, pa[kk]")],
        "mla_core.cuh": [
            ("          mma_ss(acc,\n", "          if (0) mma_ss(acc,\n"),
            ("      mma_rs(o[j], pa[kk],",
             "      if (0) mma_rs(o[j], pa[kk],")],
    },
    # MLA decode's split-K chunks (the merge kernel's share moves with them)
    "decode chunks of 64+ keys": {"mla_decode.cu": [
        ("constexpr int KCH_MIN = 128;", "constexpr int KCH_MIN = 64;")]},
    "decode chunks of 256+ keys": {"mla_decode.cu": [
        ("constexpr int KCH_MIN = 128;", "constexpr int KCH_MIN = 256;")]},
    # where a short MLA walk's fixed time goes (outputs wrong: timed only)
    "no split-K merge": {"mla_decode.cu": [
        ("  mla_decode_merge<<<", "  if (0) mla_decode_merge<<<")]},
    "no query loads": {"mla_core.cuh": [
        ("        if (live && c < CQ) {", "        if (false) {")]},
    # the bf16 range check (a value past fp16's range makes the tile be
    # copied again, rescaled) left out: its cost when nothing is past it
    # the costs of keeping fp16's range: the check for scores that are
    # not finite (a bf16 value past the range), the value-scale reference,
    # Q's row scales (outputs wrong where they matter: timed only)
    "no bf16 range check": {"mla_core.cuh": [
        ("          if constexpr (!I8 && !RS) chk = fmaf(x, 0.f, chk);\n", ""),
        ("      if constexpr (!I8 && !RS)\n"
         "        if (*FL) return false;  // CTA-uniform\n", "")]},
    "no value-scale reference": {"mla_core.cuh": [
        ("      const float v_new = fmaxf(vref, vmax);",
         "      const float v_new = 1.f;")]},
    "no Q row scales": {"mla_core.cuh": [
        ("        c2h[0] = c2 * QS[r0];\n        c2h[1] = c2 * QS[r0 + 8];\n",
         "        c2h[0] = c2h[1] = c2;\n")]},
    # where the dequant-GEMM's time goes (outputs wrong: timed only)
    "no dequant": {"qmm.cu": Alt((
        [("    dequant(kt0 + t, st);\n", "")],
        [("          pairs4<MODE>(word(lo[h], c), word(hi[h], c), MAGIC, sl, "
          "sh, hz, zl,\n                       zh, a[h]);",
          "          a[h][0] = word(lo[h], c); a[h][1] = word(hi[h], c);\n"
          "          a[h][2] = word(lo[h], c ^ 1); "
          "a[h][3] = word(hi[h], c ^ 1);"),
         ("        pairs2<MODE>(lo, hi, magic, sl, sh, hz, zl, zh, a[kk][2 * h],\n"
          "                     a[kk][2 * h + 1]);",
          "        a[kk][2 * h] = lo; a[kk][2 * h + 1] = hi;")],
    ))},
    # the first kernel's copies zero-filled; the redesign's TMA boxes all
    # taken from the first k-step (its bytes still land, from L2, not
    # device memory)
    "no q loads": {"qmm.cu": Alt((
        [("const bool ok = col < p.O && row0 + r < qrows;",
          "const bool ok = false;")],
        [("&p.tq, n0 + 128 * w,\n                      row0, b, fb);",
          "&p.tq, n0 + 128 * w,\n                      0, b, fb);"),
         ("tma_load3(smem_addr(slot + L.q), &p.tq, n0, row0, b, fb);",
          "tma_load3(smem_addr(slot + L.q), &p.tq, n0, 0, b, fb);")],
    ))},
    "no scale loads": {"qmm.cu": Alt((
        [("        const bool ok = col < p.O;\n",
          "        const bool ok = false;\n")],
        [("                      n0 + 256 * h, g0, b, fb);",
          "                      n0 + 256 * h, 0, b, fb);"),
         ("&p.ts, n0, g0, b, fb);", "&p.ts, n0, 0, b, fb);")],
    ))},
    "no x loads": {"qmm.cu": Alt((
        [("const bool ok = m < p.M && k < p.I;", "const bool ok = false;")],
        [("&p.tx, k0, 0, p.x_bs ? b : 0, fb);",
          "&p.tx, 0, 0, p.x_bs ? b : 0, fb);"),
         ("&p.tx, k0, m0, p.x_bs ? b : 0, fb);",
          "&p.tx, 0, m0, p.x_bs ? b : 0, fb);")],
    ))},
    # the splits' partial sums written, not added (the second kernel not
    # launched)
    "no split reduce": {"qmm.cu": Alt((
        [("  qmm_reduce<<<", "  if (0) qmm_reduce<<<")],
    ))},
}
#: the families a variant concerns (default: gqa and mla)
ONLY = {"default": ("gqa", "mla", "qmm"),
        "no tensor-core products": ("gqa", "mla", "qmm"),
        "decode chunks of 64+ keys": ("mla",),
        "decode chunks of 256+ keys": ("mla",), "no split-K merge": ("mla",),
        "no query loads": ("mla",), "no bf16 range check": ("mla",),
        "no value-scale reference": ("mla",), "no Q row scales": ("mla",),
        "no dequant": ("qmm",), "no q loads": ("qmm",),
        "no x loads": ("qmm",),
        "no scale loads": ("qmm",), "no split reduce": ("qmm",)}


def variants(families, only=None) -> dict:
    """The variants of the families (``only``: those named, and the
    default)."""
    return {v: e for v, e in VARIANTS.items()
            if set(ONLY.get(v, ("gqa", "mla"))) & set(families)
            and (not only or v == "default" or v in only)}


def apply_edits(variant: str, name: str, text: str, edits) -> str:
    """``text`` of source file ``name`` with the variant's edits."""
    if isinstance(edits, Alt):
        for alt in edits:
            if all(old in text for old, _ in alt):
                edits = alt
                break
        else:
            raise RuntimeError(f"{variant}: no edit set of {name} fits")
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{variant}: {old!r} not found")
        text = text.replace(old, new)
    return text


def build_all(names, families, only=None) -> dict:
    procs = {}
    for i, (variant, edits) in enumerate(variants(families, only).items()):
        d = _build.BUILD_DIR / "tune" / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        for f in _build.CSRC_DIR.iterdir():
            text = f.read_text()
            if f.name in edits and (f.suffix == ".cuh" or f.stem in names):
                text = apply_edits(variant, f.name, text, edits[f.name])
            (d / f.name).write_text(text)
        for name in names:
            lib = d / f"lib{name}.so"
            procs[(variant, name)] = (lib, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                 str(d / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def gqa_cases(seed: int) -> list:
    """(label, kind, case) of the GQA family."""
    rng = np.random.default_rng(seed)
    lens = [2048] + [int(x) for x in rng.integers(100, 2049, 7)]
    cases = [("embed", "flash", cs.make_dense(
        8, 2048, 2048, 32, 8, 128, torch.bfloat16, [0] * 8, lens, seed + 5))]
    geo = dict(H=32, KV=8, hd=128, bs=16, dtype=torch.bfloat16)
    rows = [(1, 1000), (1, 3000), (512, 512), (128, 2048)]
    llama = cs.make_case(rows, pad_rows=4, pad_tokens=6, seed=seed + 2, **geo)
    R, W = llama["bt"].shape
    T = llama["q"].shape[0]
    cases += [("mixed bf16", "ragged", llama),
              ("mixed int8 pages", "ragged", cs.int8_case(llama))]
    for part in (rows[2:3], rows[3:], rows[:2]):
        # the mixed case's launch geometry, so the same tiles split
        cases.append((f"mixed case's rows {part} alone", "ragged",
                      cs.make_case(part, pad_rows=R - len(part),
                                   pad_tokens=T - sum(q for q, _ in part),
                                   seed=seed + 2, width=W, **geo)))
    cases.append(("8 decode rows", "ragged", cs.make_case(
        [(1, int(k)) for k in rng.integers(65, 1057, 8)], pad_rows=0,
        pad_tokens=0, seed=seed + 3, **geo)))
    return cases


#: the kernel phase's DeepSeek-V2-Lite chunk grid: (start, tokens) chunks
MLA_CHUNKS = [(1976, 1024), (0, 512), (1500, 480), (900, 100)]


def mla_cases(seed: int) -> list:
    """(label, kind, case) of the MLA family, as the kernel phase makes
    them."""
    geo = dict(H=16, R=512, PR=128, rope_dim=64)
    grid = cs.make_mla_prefill(cs.mla_grid_rows(MLA_CHUNKS, spare=1), S=32,
                               bs=16, dtype=torch.bfloat16, seed=seed + 24,
                               **geo)
    dense = cs.make_mla_prefill([(0, 0, 1024), (1, 0, 1024)], S=1024, bs=16,
                                dtype=torch.bfloat16, seed=seed + 23,
                                dense_T=1024, **geo)
    dec = cs.make_mla(cs.mla_decode_kvs(seed), dtype=torch.bfloat16,
                      seed=seed + 10, bs=16, **geo)
    return [("B3m grid bf16", "mla_prefill", grid),
            ("B3m grid int8 pages", "mla_prefill", cs.mla_int8(grid)),
            ("B3m dense 2 x 1024 bf16", "mla_prefill", dense),
            ("B5 8 decode rows bf16", "mla", dec),
            ("B5b 8 decode rows int8 pages", "mla", cs.mla_int8(dec))]


#: the qmm family's weights: (label, I, O)
QMM_SHAPES = [("llama3_70b w_gate", 8192, 28672),
              ("llama3_70b w_down", 28672, 8192),
              ("llama3_70b wq", 8192, 8192),
              ("llama3_8b lm_head", 4096, 128256)]


def qmm_cases(seed: int) -> list:
    """(label, kind, (weight, x)) of the qmm family, drawn on the card as
    the kernel phase draws them."""
    g = torch.Generator(device="cuda").manual_seed(seed + 97)
    xs = {M: torch.randn((M, 28672), generator=g, device="cuda").to(
        torch.bfloat16) for M in (8, 2048)}
    cases = []
    for label, I, O in QMM_SHAPES:
        for spec in ("int4-g32", "int8"):
            qt = cs.qmm_weight(spec, (), I, O, False, seed + I + O)
            for M in (8, 2048):
                cases.append((f"{label} {spec} M={M}", "qmm",
                              (qt, xs[M][:, :I].contiguous())))
    return cases


def run_case(kind: str, label: str, case, checked: bool, iters: int) -> str:
    """The case's kernel time (checked: against its plain version first,
    with the SDPA yardstick)."""
    if kind == "qmm":
        qt, x = case
        if checked:
            r = cs.qmm_case(label, qt, x, True, iters)
            return f"{label} {r['ms']:.4f} (bf16 matmul {r['library_ms']:.4f})"
        return (f"{label} "
                f"{cs.time_ms(lambda: quant_matmul(x, qt), iters):.4f}")
    if checked:
        check = {"flash": cs.check_flash, "ragged": cs.check_ragged,
                 "mla_prefill": cs.check_mla_prefill,
                 "mla": cs.check_mla}[kind]
        kw = {"yardstick": True} if kind in ("flash", "ragged") else {}
        r = check(label, case, iters=iters, **kw)
        lib = r["library_ms"]
        return (f"{label} {r['ms']:.4f}"
                + (f" (SDPA {lib:.4f})" if lib is not None else ""))
    if kind == "flash":
        args = (case["q"], case["k"], case["v"], case["pos_base"],
                case["kv_lens"])
        fn = lambda: flash_prefill(*args)  # noqa: E731
    elif kind == "ragged":
        args = (case["q"], case["kc"], case["vc"], case["bt"], case["rows3"])
        kw = (dict(k_scales=case["ks"], v_scales=case["vs"],
                   scale_slot_base=case["base"]) if "ks" in case else {})
        fn = lambda: ragged_paged_attention(  # noqa: E731
            *args, block_size=16, **kw)
    elif kind == "mla_prefill":
        fn = cs.mla_prefill_fns(case)[0]
    else:
        fn = cs.mla_fns(case)[0]
    return f"{label} {cs.time_ms(fn, iters):.4f}"


#: run in each checkout of ``--compare`` (its own chip_smoke and kernels):
#: the main MLA cases through that checkout's check functions, one JSON
#: line of kernel times
COMPARE_MLA = r"""
import json, sys
import torch
import chip_smoke as cs
seed, kvs, chunks = json.loads(sys.argv[1])
cs.device_phase()
geo = dict(H=16, R=512, PR=128, rope_dim=64)
grid = cs.make_mla_prefill(cs.mla_grid_rows(chunks, spare=1), S=32, bs=16,
                           dtype=torch.bfloat16, seed=seed + 24, **geo)
dense = cs.make_mla_prefill([(0, 0, 1024), (1, 0, 1024)], S=1024, bs=16,
                            dtype=torch.bfloat16, seed=seed + 23,
                            dense_T=1024, **geo)
dec = cs.make_mla(kvs, dtype=torch.bfloat16, seed=seed + 10, bs=16, **geo)
res = {
    "B3m grid bf16": cs.check_mla_prefill("grid", grid),
    "B3m grid int8": cs.check_mla_prefill("grid int8", cs.mla_int8(grid)),
    "B3m dense 2 x 1024": cs.check_mla_prefill("dense", dense, iters=10),
    "B5": cs.check_mla("B5", dec),
    "B5b": cs.check_mla("B5b", cs.mla_int8(dec)),
}
print("COMPARE " + json.dumps({k: [v["ms"], v["library_ms"]]
                               for k, v in res.items()}), flush=True)
"""
#: the GQA family's main cases (the Llama-3-8B geometry, no softcap), each
#: kernel timed alone through that checkout's wrappers (the checks and the
#: yardstick stay with chip_smoke's kernel phase); the same JSON line
COMPARE_GQA = r"""
import json, sys
import numpy as np
import torch
import chip_smoke as cs
from dynamo_tpu_torch.ops.flash_prefill import flash_prefill
from dynamo_tpu_torch.ops.ragged_attention import ragged_paged_attention
seed = json.loads(sys.argv[1])[0]
cs.device_phase()
rng = np.random.default_rng(seed)
lens = [2048] + [int(x) for x in rng.integers(100, 2049, 7)]
emb = cs.make_dense(8, 2048, 2048, 32, 8, 128, torch.bfloat16, [0] * 8,
                    lens, seed + 5)
geo = dict(H=32, KV=8, hd=128, bs=16, dtype=torch.bfloat16)
llama = cs.make_case([(1, 1000), (1, 3000), (512, 512), (128, 2048)],
                     pad_rows=4, pad_tokens=6, seed=seed + 2, **geo)
dec = cs.make_case([(1, int(k)) for k in rng.integers(65, 1057, 8)],
                   pad_rows=0, pad_tokens=0, seed=seed + 3, **geo)


def ragged(case):
    kw = (dict(k_scales=case["ks"], v_scales=case["vs"],
               scale_slot_base=case["base"]) if "ks" in case else {})
    args = (case["q"], case["kc"], case["vc"], case["bt"], case["rows3"])
    return lambda: ragged_paged_attention(*args, block_size=16, **kw)


res = {
    "B3 embed 8 x 2048": cs.time_ms(lambda: flash_prefill(
        emb["q"], emb["k"], emb["v"], emb["pos_base"], emb["kv_lens"]), 20),
    "B1 mixed bf16": cs.time_ms(ragged(llama), 50),
    "B2 mixed int8": cs.time_ms(ragged(cs.int8_case(llama)), 50),
    "B1 8 decode rows": cs.time_ms(ragged(dec), 50),
}
print("COMPARE " + json.dumps({k: [v, float("nan")] for k, v in res.items()}),
      flush=True)
"""


#: the qmm family's cases, each kernel timed alone through that
#: checkout's wrapper (the checks stay with chip_smoke's kernel phase)
COMPARE_QMM = r"""
import json, sys
import torch
import chip_smoke as cs
from dynamo_tpu_torch.ops.qmm import quant_matmul
seed, shapes = json.loads(sys.argv[1])
cs.device_phase()
g = torch.Generator(device="cuda").manual_seed(seed + 97)
xs = {M: torch.randn((M, 28672), generator=g, device="cuda").to(
    torch.bfloat16) for M in (8, 2048)}
res = {}
for label, I, O in shapes:
    for spec in ("int4-g32", "int8"):
        qt = cs.qmm_weight(spec, (), I, O, False, seed + I + O)
        for M in (8, 2048):
            x = xs[M][:, :I].contiguous()
            res[f"{label} {spec} M={M}"] = cs.time_ms(
                lambda: quant_matmul(x, qt), 20 if M == 8 else 10)
        del qt
print("COMPARE " + json.dumps({k: [v, float("nan")] for k, v in res.items()}),
      flush=True)
"""
COMPARE = {"gqa": COMPARE_GQA, "mla": COMPARE_MLA, "qmm": COMPARE_QMM}


def compare(dirs, seed: int, family: str = "mla") -> int:
    smi, _ = cs.device_phase()
    arg = json.dumps([seed, QMM_SHAPES] if family == "qmm" else
                     [seed, cs.mla_decode_kvs(seed), MLA_CHUNKS])
    script = COMPARE[family]
    runs = []
    for d in dirs:
        d = os.path.abspath(d)
        p = subprocess.run([sys.executable, "-c", script, arg], cwd=d,
                           env=dict(os.environ, PYTHONPATH=d),
                           capture_output=True, text=True)
        sys.stdout.write(p.stdout)
        if p.returncode != 0:
            sys.stdout.write(p.stderr)
            raise RuntimeError(f"{d}: exit {p.returncode}")
        line = [x for x in p.stdout.splitlines()
                if x.startswith("COMPARE ")][-1]
        runs.append((d, json.loads(line[len("COMPARE "):])))
    print(f"[{smi}] kernel ms by checkout, in run order "
          f"(SDPA of the last run in parentheses, where timed):")
    for case in runs[0][1]:
        times = " / ".join(f"{r[case][0]:.4f}" for _, r in runs)
        sdpa = runs[-1][1][case][1]
        print(f"  {case}: {times}"
              + ("" if sdpa != sdpa else f" ({sdpa:.4f})"))
    print("  checkouts: " + ", ".join(os.path.basename(d) for d, _ in runs))
    return 0


#: the M of ``--crossover`` (the decode body takes up to 16 rows)
CROSSOVER_M = (1, 8, 16, 24, 32, 48, 64)


def crossover(seed: int) -> int:
    """Both dequant-GEMM bodies, forced, at each M of ``CROSSOVER_M`` on
    Llama-3-70B's w_gate (int4-g32 and int8), kernel ms."""
    smi, _ = cs.device_phase()
    g = torch.Generator(device="cuda").manual_seed(seed + 97)
    x = torch.randn((max(CROSSOVER_M), 8192), generator=g,
                    device="cuda").to(torch.bfloat16)
    for spec in ("int4-g32", "int8"):
        qt = cs.qmm_weight(spec, (), 8192, 28672, False, seed + 8192 + 28672)
        out = []
        for M in CROSSOVER_M:
            xm = x[:M].contiguous()
            times = []
            for body in ("decode", "prefill")[0 if M <= 16 else 1:]:
                ms = cs.time_ms(
                    lambda: quant_matmul(xm, qt, body=body), 20)
                times.append(f"{body} {ms:.4f}")
            out.append(f"M={M}: " + ", ".join(times))
        print(f"[{smi}] llama3_70b w_gate {spec}, ms by body: "
              + "; ".join(out), flush=True)
        del qt
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--family", choices=("gqa", "mla", "qmm", "all"),
                    default="all")
    ap.add_argument("--compare", nargs="+", metavar="DIR")
    ap.add_argument("--variant", action="append", choices=list(VARIANTS),
                    help="time only this variant beside the default "
                         "(repeatable)")
    ap.add_argument("--crossover", action="store_true",
                    help="time both dequant-GEMM bodies across M")
    a = ap.parse_args()
    if a.crossover:
        return crossover(a.seed)
    if a.compare:
        return compare(a.compare, a.seed,
                       a.family if a.family != "all" else "mla")
    families = ("gqa", "mla", "qmm") if a.family == "all" else (a.family,)
    smi, _ = cs.device_phase()
    libs = build_all([n for f in families for n in NAMES[f]], families,
                     a.variant)
    cases = []
    for f in families:
        cases += {"gqa": gqa_cases, "mla": mla_cases,
                  "qmm": qmm_cases}[f](a.seed)
    load = _build.load
    try:
        for variant, edits in variants(families, a.variant).items():
            _build.load = lambda n, v=variant: libs[(v, n)]
            out = [run_case(kind, label, case, not edits,
                            10 if kind == "flash" or "dense" in label
                            or "M=2048" in label else 20)
                   for label, kind, case in cases]
            print(f"[{smi}] {variant}: " + "; ".join(out) + " ms",
                  flush=True)
    finally:
        _build.load = load
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
