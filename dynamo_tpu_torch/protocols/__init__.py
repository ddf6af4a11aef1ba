"""Engine-facing request/response types, the port's copy of
``dynamo_tpu/protocols``.

``PreprocessedRequest`` is what reaches an engine; ``LLMEngineOutput`` is
what it streams back. Both serialize to the same plain msgpack/JSON dicts
as the JAX package's (``to_wire``/``from_wire``), so a torch worker and a
JAX worker speak one wire format.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Optional

TokenId = int


class FinishReason:
    STOP = "stop"
    LENGTH = "length"
    EOS = "eos"
    CANCELLED = "cancelled"
    CONTENT_FILTER = "content_filter"
    ERROR = "error"
    #: the request's end-to-end deadline expired mid-generation
    DEADLINE = "deadline"


@dataclass
class StopConditions:
    max_tokens: Optional[int] = None
    stop: Optional[list[str]] = None
    stop_token_ids_hidden: Optional[list[TokenId]] = None
    min_tokens: Optional[int] = None
    ignore_eos: Optional[bool] = None


@dataclass
class SamplingOptions:
    n: Optional[int] = None
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    seed: Optional[int] = None
    presence_penalty: Optional[float] = None
    frequency_penalty: Optional[float] = None
    repetition_penalty: Optional[float] = None
    #: token-id (stringified on the wire) → additive logit bias
    logit_bias: Optional[dict] = None
    #: guided decoding: one of {"json", "regex", "choice", "grammar"}
    guided: Optional[dict] = None


@dataclass
class OutputOptions:
    logprobs: Optional[int] = None
    prompt_logprobs: Optional[int] = None
    skip_special_tokens: bool = True
    echo: bool = False


@dataclass
class PreprocessedRequest:
    """Internal representation of an LLM request."""

    model: str
    token_ids: list[TokenId]
    stop_conditions: StopConditions = field(default_factory=StopConditions)
    sampling_options: SamplingOptions = field(default_factory=SamplingOptions)
    output_options: OutputOptions = field(default_factory=OutputOptions)
    eos_token_ids: list[TokenId] = field(default_factory=list)
    mdc_sum: Optional[str] = None
    annotations: list[str] = field(default_factory=list)
    #: set by the KV router: prefix blocks the chosen worker already has
    estimated_prefix_hit_num_blocks: Optional[int] = None
    #: pin the request to a specific worker instance
    backend_instance_id: Optional[int] = None
    router_config_override: Optional[dict] = None
    #: multimodal segments ({"start", "embeds"}) and unresolved references
    mm_embeds: Optional[list] = None
    mm_refs: Optional[list] = None
    #: migration restore plan; absent on the wire unless set
    restore: Optional[dict] = None
    #: prefix onboarding plan; absent on the wire unless set
    onboard: Optional[dict] = None

    def to_wire(self) -> dict:
        d = asdict(self)
        for key in ("restore", "onboard"):
            if d.get(key) is None:
                d.pop(key)
        return d

    @staticmethod
    def from_wire(d: dict) -> "PreprocessedRequest":
        return PreprocessedRequest(
            model=d["model"],
            token_ids=list(d.get("token_ids") or []),
            stop_conditions=StopConditions(**(d.get("stop_conditions") or {})),
            sampling_options=SamplingOptions(
                **(d.get("sampling_options") or {})),
            output_options=OutputOptions(**(d.get("output_options") or {})),
            eos_token_ids=list(d.get("eos_token_ids") or []),
            mdc_sum=d.get("mdc_sum"),
            annotations=list(d.get("annotations") or []),
            estimated_prefix_hit_num_blocks=d.get(
                "estimated_prefix_hit_num_blocks"),
            backend_instance_id=d.get("backend_instance_id"),
            mm_embeds=d.get("mm_embeds"),
            mm_refs=d.get("mm_refs"),
            router_config_override=d.get("router_config_override"),
            restore=d.get("restore"),
            onboard=d.get("onboard"),
        )


@dataclass
class LLMEngineOutput:
    """One step of engine output."""

    token_ids: list[TokenId] = field(default_factory=list)
    tokens: Optional[list[str]] = None
    text: Optional[str] = None
    cum_log_probs: Optional[float] = None
    log_probs: Optional[list[float]] = None
    #: per emitted token: top-k alternatives as [token_id, logprob] pairs
    top_logprobs: Optional[list[list]] = None
    finish_reason: Optional[str] = None
    index: Optional[int] = None
    kv_transfer_params: Optional[dict] = None
    #: serving-worker flight identity on the first token-bearing frame
    flight: Optional[dict] = None

    def to_wire(self) -> dict:
        d = {"token_ids": self.token_ids}
        for k in ("tokens", "text", "cum_log_probs", "log_probs",
                  "top_logprobs", "finish_reason", "index",
                  "kv_transfer_params", "flight"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        return d

    @staticmethod
    def from_wire(d: dict) -> "LLMEngineOutput":
        return LLMEngineOutput(
            token_ids=list(d.get("token_ids") or []),
            tokens=d.get("tokens"),
            text=d.get("text"),
            cum_log_probs=d.get("cum_log_probs"),
            log_probs=d.get("log_probs"),
            top_logprobs=d.get("top_logprobs"),
            finish_reason=d.get("finish_reason"),
            index=d.get("index"),
            kv_transfer_params=d.get("kv_transfer_params"),
            flight=d.get("flight"),
        )
