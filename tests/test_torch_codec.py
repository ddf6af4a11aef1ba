"""The port's msgpack (``dynamo_tpu_torch/runtime/codec.py``) against the
``msgpack`` package the JAX runtime's wire uses.

Its bytes must equal ``msgpack.packb(obj, use_bin_type=True)`` and its
decoder must equal ``msgpack.unpackb(data, raw=False)`` on the payloads the
fleet sends, at every width boundary of the format, and on
hypothesis-drawn nested values: a torch worker and a JAX process read and
write each other's frames byte for byte.
"""

import asyncio

import msgpack
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.llm.model_card import ModelDeploymentCard, ModelEntry
from dynamo_tpu.protocols import (
    LLMEngineOutput, OutputOptions, PreprocessedRequest, SamplingOptions,
    StopConditions,
)
from dynamo_tpu.router.protocols import (
    ForwardPassMetrics, KvCacheEvent, KvStats, RouterEvent, StoredBlock,
    WorkerStats,
)
from dynamo_tpu.runtime.component import Instance
from dynamo_tpu_torch.runtime import codec


def _ref(obj) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def _same(obj) -> None:
    """Port bytes == msgpack bytes, and both decoders agree on them."""
    data = codec.packb(obj)
    assert data == _ref(obj)
    want = msgpack.unpackb(data, raw=False)
    got = codec.unpackb(data)
    assert got == want
    assert _types(got) == _types(want)


def _types(x):
    """The value's type tree (1 == 1.0 == True, so equality alone cannot
    tell an int from a float or a bool)."""
    if isinstance(x, dict):
        return {k: _types(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_types(v) for v in x]
    return type(x).__name__


# ------------------------------------------------------ the fleet's payloads


def _request() -> dict:
    return PreprocessedRequest(
        model="llama", token_ids=[1, 300, 70000, 2 ** 31 + 5],
        stop_conditions=StopConditions(max_tokens=32, ignore_eos=True,
                                       stop=["</s>"]),
        sampling_options=SamplingOptions(temperature=0.0, top_p=1.0,
                                         seed=7, logit_bias={"3": -1.5}),
        output_options=OutputOptions(logprobs=2),
        eos_token_ids=[128001, 128009], annotations=["kv_chunks"],
        estimated_prefix_hit_num_blocks=3, backend_instance_id=2 ** 60 + 9,
        restore={"sources": [[2 ** 62, 12, 1.25]], "blocks": 12},
    ).to_wire()


def _card() -> dict:
    card = ModelDeploymentCard(display_name="Llama-3-8B", eos_token_ids=[2],
                               tokenizer_ref="/ckpt", context_length=8192)
    card.runtime_config.total_kv_blocks = 123456
    return card.to_wire()


PAYLOADS = {
    "request": _request,
    "engine_output": lambda: LLMEngineOutput(
        token_ids=[42], log_probs=[-0.125], finish_reason="length",
        top_logprobs=[[[42, -0.125], [7, -3.5]]]).to_wire(),
    "engine_error": lambda: LLMEngineOutput(
        finish_reason="error", text="engine step failed").to_wire(),
    "kv_stored": lambda: RouterEvent(2 ** 57 + 3, KvCacheEvent.stored(
        4, None, [StoredBlock(2 ** 64 - 1, 2 ** 63),
                  StoredBlock(12345, 2 ** 40)])).to_wire(),
    "kv_removed": lambda: RouterEvent(9, KvCacheEvent.removed(
        5, [2 ** 64 - 2, 1])).to_wire(),
    "kv_cleared": lambda: RouterEvent(9, KvCacheEvent.clear(6)).to_wire(),
    "load_metrics": lambda: {"worker_id": 2 ** 50, "metrics": ForwardPassMetrics(
        worker_stats=WorkerStats(request_active_slots=3,
                                 request_total_slots=64),
        kv_stats=KvStats(kv_active_blocks=10, kv_total_blocks=1000,
                         gpu_cache_usage_perc=0.01)).to_wire()},
    "instance": lambda: Instance("dynamo", "backend", "generate",
                                 0x1A14A884E7475A3,
                                 {"pod": "w-0"}).to_wire(),
    "model_entry": lambda: ModelEntry(
        name="Llama-3-8B", namespace="dynamo", component="backend",
        endpoint="generate", instance_id=0x1A14A884E7475A3,
        card=ModelDeploymentCard.from_wire(_card())).to_wire(),
    "plane_request": lambda: {"t": "req", "id": 17, "op": "kv_put",
                              "key": "instances/dynamo/backend/generate:1f",
                              "value": b"\x81\xa1a\x01", "lease": 2 ** 45},
    "plane_reply": lambda: {"t": "res", "id": 17, "ok": True,
                            "value": {"k": b"v" * 300}},
    "response_frames": lambda: [{"t": "data", "d": {"token_ids": [5]}},
                                {"t": "complete"},
                                {"t": "err", "msg": "stream disconnected",
                                 "retryable": True, "code": None}],
    "envelope": lambda: {"ctx": {"id": "ab" * 16, "annotations": {},
                                 "traceparent": None, "deadline_ms": 1500},
                         "conn": {"host": "10.0.0.2", "port": 40123,
                                  "stream_id": "cd" * 16, "local": False},
                         "req": _request()},
}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_fleet_payload_bytes_match_msgpack(name):
    _same(PAYLOADS[name]())


# ------------------------------------------------------ width boundaries


def _int_edges():
    out = {0, -1, 127, 128, -32, -33}
    for k in (7, 8, 15, 16, 31, 32, 63):
        out |= {2 ** k - 1, 2 ** k, -(2 ** k), -(2 ** k) - 1}
    out.add(2 ** 64 - 1)
    return sorted(x for x in out if -(2 ** 63) <= x < 2 ** 64)


@pytest.mark.parametrize("x", _int_edges())
def test_int_widths(x):
    _same(x)


@pytest.mark.parametrize("n", [0, 1, 31, 32, 255, 256, 65535, 65536])
def test_str_and_bin_lengths(n):
    _same("x" * n)
    _same("é" * (n // 2))  # multi-byte: the byte length sets the width
    _same(b"\x00" * n)
    _same(bytearray(b"\x7f" * n))


@pytest.mark.parametrize("n", [0, 1, 15, 16, 65535, 65536])
def test_array_and_map_sizes(n):
    _same(list(range(n)))
    _same(tuple(range(n)))
    _same({f"k{i}": i for i in range(n)})


@pytest.mark.parametrize("x", [0.0, -0.0, 1.5, -2.25, 1e300, 5e-324,
                               float("inf"), float("-inf"), 3.1415926535])
def test_floats_are_float64(x):
    assert codec.packb(x)[0] == 0xCB
    _same(x)


def test_scalars():
    for x in (None, True, False, [True, 1, 1.0, None]):
        _same(x)


def test_out_of_range_and_unknown_types_refused_like_msgpack():
    for bad in (2 ** 64, -(2 ** 63) - 1):
        with pytest.raises(OverflowError):
            codec.packb(bad)
        with pytest.raises(OverflowError):
            _ref(bad)
    for bad in ({1, 2}, object()):
        with pytest.raises(TypeError):
            codec.packb(bad)
        with pytest.raises(TypeError):
            _ref(bad)


def test_decoder_follows_strict_map_key_and_float32():
    # an int map key: refused by msgpack's default strict_map_key
    data = _ref({1: "a"})
    with pytest.raises(ValueError):
        msgpack.unpackb(data, raw=False)
    with pytest.raises(ValueError):
        codec.unpackb(data)
    # a bin map key is allowed; float32 (another writer's) decodes as float
    assert codec.unpackb(_ref({b"k": 1})) == {b"k": 1}
    f32 = msgpack.packb(1.5, use_single_float=True)
    assert codec.unpackb(f32) == msgpack.unpackb(f32) == 1.5


def test_decoder_rejects_truncated_and_trailing_bytes():
    data = _ref({"a": [1, 2, 3]})
    with pytest.raises(ValueError):
        codec.unpackb(data[:-1])
    with pytest.raises(ValueError):
        codec.unpackb(data + b"\xc0")


# ------------------------------------------------------ hypothesis values

_keys = st.one_of(st.text(max_size=40), st.binary(max_size=40))
_leaves = st.one_of(
    st.none(), st.booleans(),
    st.integers(min_value=-(2 ** 63), max_value=2 ** 64 - 1),
    st.floats(allow_nan=False), st.text(max_size=100),
    st.binary(max_size=300))
_values = st.recursive(
    _leaves,
    lambda inner: st.one_of(st.lists(inner, max_size=20),
                            st.dictionaries(_keys, inner, max_size=20)),
    max_leaves=30)


@settings(max_examples=100, deadline=None)
@given(_values)
def test_hypothesis_values_match_msgpack(obj):
    _same(obj)


# ------------------------------------------------------ frames


def test_frames_round_trip_through_a_stream():
    async def run():
        reader = asyncio.StreamReader()
        objs = [PAYLOADS[n]() for n in sorted(PAYLOADS)]
        for o in objs:
            frame = codec.pack_frame(o)
            assert frame[4:] == _ref(o)
            assert int.from_bytes(frame[:4], "big") == len(frame) - 4
            reader.feed_data(frame)
        reader.feed_eof()
        got = [await codec.read_frame(reader) for _ in objs]
        assert got == [msgpack.unpackb(_ref(o), raw=False) for o in objs]
        with pytest.raises(asyncio.IncompleteReadError):
            await codec.read_frame(reader)

    asyncio.run(run())
