"""The torch port's boundary with the JAX package.

- No module of ``dynamo_tpu_torch`` and nothing in ``chip_smoke.py``
  imports ``jax`` (or ``jaxlib``, ...) or the ``dynamo_tpu`` package: the
  port keeps its own copies, and runs where JAX is not installed. Nor do
  they import ``msgpack``, ``safetensors``, ``aiohttp`` or ``ml_dtypes``
  (the disagg wire carries bf16 without it), and the worker entry point
  (every role's handlers with it) imports in an interpreter where those,
  ``jinja2``, ``tokenizers`` and ``transformers`` cannot be imported.
- The port's pure-Python XXH3-64 gives the JAX package's (xxhash) block and
  sequence hashes bit for bit, the KV identity a mixed fleet shares.
"""

import ast
import pathlib
import random

import pytest

from dynamo_tpu import tokens as ref_tokens
from dynamo_tpu_torch import tokens

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "dynamo_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path: pathlib.Path) -> set:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return mods


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top.startswith("jax") or top == "dynamo_tpu"


def test_port_files_found():
    assert len(PORT_FILES) > 10
    assert all(p.exists() for p in PORT_FILES)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(m for m in _imports(path) if _forbidden(m))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_wire_package_imports(path):
    """The port keeps its own msgpack and safetensors reader, and serves no
    HTTP: the card's machine need not have these packages."""
    bad = sorted(m for m in _imports(path)
                 if m.split(".")[0] in ("msgpack", "safetensors", "aiohttp",
                                        "ml_dtypes"))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_rule():
    assert _forbidden("jax.numpy") and _forbidden("jaxlib")
    assert _forbidden("dynamo_tpu") and _forbidden("dynamo_tpu.tokens")
    assert not _forbidden("dynamo_tpu_torch.tokens")
    assert not _forbidden("torch")


@pytest.mark.parametrize("block_size", [1, 2, 4, 16, 32, 60])
def test_block_and_sequence_hashes_match(block_size):
    rng = random.Random(block_size)
    for _ in range(20):
        n = block_size * rng.randint(1, 6) + rng.randint(0, block_size - 1)
        toks = [rng.getrandbits(32) for _ in range(n)]
        salt = rng.choice([ref_tokens.KV_HASH_SEED, rng.getrandbits(64)])
        want = ref_tokens.TokenBlockSequence.from_tokens(toks, block_size,
                                                         salt)
        got = tokens.TokenBlockSequence.from_tokens(toks, block_size, salt)
        assert got.block_hashes() == want.block_hashes()
        assert got.sequence_hashes() == want.sequence_hashes()
        assert got.current_tokens == want.current_tokens


def test_xxh3_every_short_length():
    rng = random.Random(0)
    for n in range(0, 241):
        data = bytes(rng.getrandbits(8) for _ in range(n))
        seed = rng.getrandbits(64)
        assert tokens.xxh3_64(data, seed) == ref_tokens.compute_hash(data,
                                                                     seed)


def test_xxh3_refuses_long_input():
    with pytest.raises(ValueError, match="240"):
        tokens.xxh3_64(bytes(241))


#: packages the card's machine need not have; the worker's import closure
#: must load none of them
ABSENT_ON_CARD = ("jax", "jaxlib", "dynamo_tpu", "msgpack", "safetensors",
                  "aiohttp", "jinja2", "tokenizers", "transformers",
                  "ml_dtypes")


def test_worker_imports_with_jax_and_wire_packages_blocked():
    """In a fresh interpreter where importing any of ABSENT_ON_CARD fails,
    the worker entry point, its loader and engine, the KVBM tiers and
    chip_smoke.py import, the disk tier writes and reads a bf16 block, and
    the worker parses and checks a command line."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        f"for name in {ABSENT_ON_CARD!r}:\n"
        "    sys.modules[name] = None\n"
        "import dynamo_tpu_torch.engine.main as m\n"
        "import dynamo_tpu_torch.engine.loader, dynamo_tpu_torch.engine.engine\n"
        "import dynamo_tpu_torch.disagg.transfer, dynamo_tpu_torch.kvbm.distributed\n"
        "import dynamo_tpu_torch.kvbm.manager, dynamo_tpu_torch.kvbm.tiers as kt\n"
        "import chip_smoke, shutil, tempfile, torch\n"
        "d = tempfile.mkdtemp()\n"
        "x = torch.arange(8, dtype=torch.bfloat16).reshape(2, 4)\n"
        "t = kt.DiskTier(d, 1 << 20)\n"
        "t.put(1, x, x)  # a bf16 file written and read without ml_dtypes\n"
        "assert torch.equal(t.get(1)[0], x)\n"
        "shutil.rmtree(d)\n"
        "cli = m.build_parser().parse_args(['--arch', 'tiny', '--device',\n"
        "    'cpu', '--allow-test-metadata'])\n"
        "cfg, args, eos, tk = m.configure(cli)\n"
        "assert args.pipeline_decode and eos == [2] and tk == 'test'\n"
        "loaded = [n for n in sys.modules if n.split('.')[0] in\n"
        f"          {ABSENT_ON_CARD!r} and sys.modules[n] is not None]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
