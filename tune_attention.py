#!/usr/bin/env python3
"""Where the GQA attention kernels' time goes, on one CUDA card.

    python3 tune_attention.py [--seed N]

Builds ``flash_prefill.cu`` and ``ragged_attention.cu`` (over
``attention_core.cuh``) once for each variant below, from copies of
``dynamo_tpu_torch/ops/csrc`` in the ignored ``ops/build/tune/`` (one nvcc
per library, all started together), and times each build on the cases of
``chip_smoke.py``'s kernel phase: flash prefill at the Llama-3-8B
embeddings geometry, the ragged kernel's Llama-3-8B mixed case on bf16 and
int8 pages, its rows alone (the 512-token prefill, the 128-token chunk at
kv 2048, the two decode rows) and eight decode rows. Variants:

- ``default``: the sources as they are;
- ``no key copies``: the copies of every key tile after the first left out
  (the kernel computes on stale tiles: its time without the copies);
- ``no tensor-core products``: the wgmma instructions left out (its time
  without the two products).

The default build is held against the plain versions with
``chip_smoke``'s tolerances before it is timed (with the SDPA yardstick
beside it); the ablated ones are only timed. The
card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import numpy as np
import torch

import chip_smoke as cs
from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.ops.flash_prefill import flash_prefill
from dynamo_tpu_torch.ops.ragged_attention import ragged_paged_attention

NAMES = ("flash_prefill", "ragged_attention")
#: variant: text replacements in attention_core.cuh (none: the default,
#: checked against the plain versions)
VARIANTS = {
    "default": [],
    "no key copies": [("      load(it + 1, sl);\n", "")],
    "no tensor-core products": [
        ("      mma_ss_n64(s,", "      if (0) mma_ss_n64(s,"),
        ("      mma_rs(o, pa[kk]", "      if (0) mma_rs(o, pa[kk]")],
}


def build_all() -> dict:
    procs = {}
    for i, (variant, edits) in enumerate(VARIANTS.items()):
        d = _build.BUILD_DIR / "tune" / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        for f in _build.CSRC_DIR.iterdir():
            text = f.read_text()
            if f.name == "attention_core.cuh":
                for old, new in edits:
                    if old not in text:
                        raise RuntimeError(f"{variant}: {old!r} not found")
                    text = text.replace(old, new)
            (d / f.name).write_text(text)
        for name in NAMES:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    seed = ap.parse_args().seed
    smi, _ = cs.device_phase()
    libs = build_all()
    rng = np.random.default_rng(seed)
    lens = [2048] + [int(x) for x in rng.integers(100, 2049, 7)]
    emb = cs.make_dense(8, 2048, 2048, 32, 8, 128, torch.bfloat16, [0] * 8,
                        lens, seed + 5)
    geo = dict(H=32, KV=8, hd=128, bs=16, dtype=torch.bfloat16)
    rows = [(1, 1000), (1, 3000), (512, 512), (128, 2048)]
    llama = cs.make_case(rows, pad_rows=4, pad_tokens=6, seed=seed + 2, **geo)
    R, W = llama["bt"].shape
    T = llama["q"].shape[0]
    ragged = [("mixed bf16", llama), ("mixed int8 pages", cs.int8_case(llama))]
    for part in (rows[2:3], rows[3:], rows[:2]):
        # the mixed case's launch geometry, so the same tiles split
        ragged.append((f"mixed case's rows {part} alone", cs.make_case(
            part, pad_rows=R - len(part),
            pad_tokens=T - sum(q for q, _ in part), seed=seed + 2, width=W,
            **geo)))
    ragged.append(("8 decode rows", cs.make_case(
        [(1, int(k)) for k in rng.integers(65, 1057, 8)], pad_rows=0,
        pad_tokens=0, seed=seed + 3, **geo)))

    load = _build.load
    try:
        for variant, edits in VARIANTS.items():
            _build.load = lambda n, v=variant: libs[(v, n)]
            checked = not edits
            out = []
            if checked:
                r = cs.check_flash(f"{variant}: embed", emb, iters=10)
                out.append(f"embed {r['ms']:.4f} (SDPA "
                           f"{r['library_ms']:.4f})")
            else:
                args = (emb["q"], emb["k"], emb["v"], emb["pos_base"],
                        emb["kv_lens"])
                t = cs.time_ms(lambda: flash_prefill(*args), 10)
                out.append(f"embed {t:.4f}")
            for label, case in ragged:
                if checked:
                    r = cs.check_ragged(f"{variant}: {label}", case, iters=20)
                    out.append(f"{label} {r['ms']:.4f} (SDPA "
                               f"{r['library_ms']:.4f})")
                    continue
                args = (case["q"], case["kc"], case["vc"], case["bt"],
                        case["rows3"])
                kw = (dict(k_scales=case["ks"], v_scales=case["vs"],
                           scale_slot_base=case["base"])
                      if "ks" in case else {})
                t = cs.time_ms(lambda: ragged_paged_attention(
                    *args, block_size=16, **kw), 20)
                out.append(f"{label} {t:.4f}")
            print(f"[{smi}] {variant}: " + "; ".join(out) + " ms",
                  flush=True)
    finally:
        _build.load = load
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
