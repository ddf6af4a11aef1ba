#!/usr/bin/env python3
"""Where the attention kernels' time goes, on one CUDA card.

    python3 tune_attention.py [--family gqa|mla|all] [--variant NAME]...
                              [--seed N]
    python3 tune_attention.py --compare DIR [DIR ...] [--family gqa|mla]
                              [--seed N]

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
  prefill, and MLA decode (B5, B5b) at eight rows of kv 73-2582.

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
  walk.

The default build is held against the plain versions with
``chip_smoke``'s tolerances before it is timed (with the SDPA yardstick
beside it); the ablated ones are only timed. The card's name and power
limit come first.

``--compare`` times the main cases of a family in each checkout DIR in
turn, each in its own process with that checkout's ``chip_smoke.py`` and
kernels, and prints one line per run and a table: give a parent and a
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
from dynamo_tpu_torch.ops.ragged_attention import ragged_paged_attention

NAMES = {"gqa": ("flash_prefill", "ragged_attention"),
         "mla": ("mla_prefill", "mla_decode")}
#: variant: text replacements by source file (none: the default, checked
#: against the plain versions)
VARIANTS = {
    "default": {},
    "no key copies": {
        "attention_core.cuh": [("      load(it + 1, sl);\n", "")],
        "mla_core.cuh": [("          load((it + 1) & 1, slot);\n", "")],
    },
    "no tensor-core products": {
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
}
#: the families a variant concerns (default: both)
ONLY = {"decode chunks of 64+ keys": "mla",
        "decode chunks of 256+ keys": "mla", "no split-K merge": "mla",
        "no query loads": "mla", "no bf16 range check": "mla",
        "no value-scale reference": "mla", "no Q row scales": "mla"}


def variants(families, only=None) -> dict:
    """The variants of the families (``only``: those named, and the
    default)."""
    return {v: e for v, e in VARIANTS.items()
            if ONLY.get(v, families[0]) in families
            and (not only or v == "default" or v in only)}


def build_all(names, families, only=None) -> dict:
    procs = {}
    for i, (variant, edits) in enumerate(variants(families, only).items()):
        d = _build.BUILD_DIR / "tune" / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        for f in _build.CSRC_DIR.iterdir():
            text = f.read_text()
            for old, new in edits.get(f.name, []):
                if old not in text:
                    raise RuntimeError(f"{variant}: {old!r} not found")
                text = text.replace(old, new)
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


def run_case(kind: str, label: str, case, checked: bool, iters: int) -> str:
    """The case's kernel time (checked: against its plain version first,
    with the SDPA yardstick)."""
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


def compare(dirs, seed: int, family: str = "mla") -> int:
    smi, _ = cs.device_phase()
    arg = json.dumps([seed, cs.mla_decode_kvs(seed), MLA_CHUNKS])
    script = COMPARE_GQA if family == "gqa" else COMPARE_MLA
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--family", choices=("gqa", "mla", "all"),
                    default="all")
    ap.add_argument("--compare", nargs="+", metavar="DIR")
    ap.add_argument("--variant", action="append", choices=list(VARIANTS),
                    help="time only this variant beside the default "
                         "(repeatable)")
    a = ap.parse_args()
    if a.compare:
        return compare(a.compare, a.seed,
                       "gqa" if a.family == "gqa" else "mla")
    families = ("gqa", "mla") if a.family == "all" else (a.family,)
    smi, _ = cs.device_phase()
    libs = build_all([n for f in families for n in NAMES[f]], families,
                     a.variant)
    cases = []
    for f in families:
        cases += gqa_cases(a.seed) if f == "gqa" else mla_cases(a.seed)
    load = _build.load
    try:
        for variant, edits in variants(families, a.variant).items():
            _build.load = lambda n, v=variant: libs[(v, n)]
            out = [run_case(kind, label, case, not edits,
                            10 if kind == "flash" or "dense" in label
                            else 20)
                   for label, kind, case in cases]
            print(f"[{smi}] {variant}: " + "; ".join(out) + " ms",
                  flush=True)
    finally:
        _build.load = load
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
