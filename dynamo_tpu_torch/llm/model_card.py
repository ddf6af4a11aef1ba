"""Model Deployment Card (MDC) and model registration keys, the port's copy
of ``dynamo_tpu/llm/model_card.py``.

The MDC is the per-model contract carried from worker registration to
every frontend: context length, KV block size, migration limit, runtime
capacity knobs, tokenizer and template references. Registered models live
in the control plane's KV store under ``models/<slug>/<lease-hex>/<type>``
with the JAX package's bytes, so the JAX frontend's ``ModelWatcher`` finds
a torch worker as it finds a JAX one.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass, field
from typing import Optional

from dynamo_tpu_torch.runtime.codec import packb

MODEL_ROOT = "models"

#: model input/output kinds a worker can register (ref: bindings lib.rs register_llm)
MODEL_INPUT_TOKENS = "tokens"
MODEL_INPUT_TEXT = "text"
MODEL_TYPE_CHAT = "chat"
MODEL_TYPE_COMPLETIONS = "completions"
MODEL_TYPE_EMBEDDINGS = "embeddings"


def resolve_eos_token_ids(model_path: str) -> list[int]:
    """EOS ids from generation_config.json, falling back to config.json.

    (ref: model_card.rs loads the same HF artifacts for its MDC.)
    Raises ValueError when neither file yields an ``eos_token_id``.
    """
    import os

    def _norm(v):
        if v is None:
            return []
        return [int(x) for x in (v if isinstance(v, list) else [v])]

    for name in ("generation_config.json", "config.json"):
        p = os.path.join(model_path, name)
        if os.path.exists(p):
            with open(p) as f:
                ids = _norm(json.load(f).get("eos_token_id"))
            if ids:
                return ids
    raise ValueError(
        f"could not resolve eos_token_id from {model_path}; pass explicit EOS ids")


def slugify(name: str) -> str:
    out = []
    for ch in name:
        if ch.isalnum() or ch in "._":
            out.append(ch)
        else:
            out.append("-")
    return "".join(out).strip("-").lower() or "model"


@dataclass
class ModelRuntimeConfig:
    """Engine capacity knobs (ref: local_model/runtime_config.rs)."""

    total_kv_blocks: Optional[int] = None
    max_num_seqs: Optional[int] = None
    max_num_batched_tokens: Optional[int] = None
    tool_call_parser: Optional[str] = None
    reasoning_parser: Optional[str] = None


@dataclass
class ModelDeploymentCard:
    display_name: str
    context_length: int = 8192
    kv_cache_block_size: int = 16
    migration_limit: int = 3
    #: tokenizer source: a local dir with tokenizer.json, or "test" for the
    #: in-memory test tokenizer
    tokenizer_ref: str = "test"
    chat_template: Optional[str] = None
    eos_token_ids: list[int] = field(default_factory=list)
    #: placeholder tokens emitted per image in multimodal prompts (the
    #: vision tower's patch-token count; ref surface: trtllm multimodal
    #: encode helper)
    mm_placeholder_tokens: int = 16
    runtime_config: ModelRuntimeConfig = field(default_factory=ModelRuntimeConfig)
    user_data: dict = field(default_factory=dict)

    @property
    def slug(self) -> str:
        return slugify(self.display_name)

    def checksum(self) -> str:
        d = asdict(self)
        return hashlib.sha256(json.dumps(d, sort_keys=True).encode()).hexdigest()[:16]

    def to_wire(self) -> dict:
        return asdict(self)

    @staticmethod
    def from_wire(d: dict) -> "ModelDeploymentCard":
        rc = d.get("runtime_config") or {}
        return ModelDeploymentCard(
            display_name=d["display_name"],
            context_length=d.get("context_length", 8192),
            kv_cache_block_size=d.get("kv_cache_block_size", 16),
            migration_limit=d.get("migration_limit", 3),
            tokenizer_ref=d.get("tokenizer_ref", "test"),
            chat_template=d.get("chat_template"),
            eos_token_ids=list(d.get("eos_token_ids") or []),
            mm_placeholder_tokens=d.get("mm_placeholder_tokens", 16),
            runtime_config=ModelRuntimeConfig(**rc),
            user_data=d.get("user_data") or {},
        )


@dataclass
class ModelEntry:
    """One worker's registration of one model (ref: discovery/model_entry.rs)."""

    name: str
    namespace: str
    component: str
    endpoint: str
    instance_id: int
    model_type: str = MODEL_TYPE_CHAT  # chat | completions | embeddings
    model_input: str = MODEL_INPUT_TOKENS
    card: Optional[ModelDeploymentCard] = None

    def key(self) -> str:
        return f"{MODEL_ROOT}/{slugify(self.name)}/{self.instance_id:x}"

    def to_wire(self) -> dict:
        d = {
            "name": self.name,
            "namespace": self.namespace,
            "component": self.component,
            "endpoint": self.endpoint,
            "instance_id": self.instance_id,
            "model_type": self.model_type,
            "model_input": self.model_input,
        }
        if self.card is not None:
            d["card"] = self.card.to_wire()
        return d

    @staticmethod
    def from_wire(d: dict) -> "ModelEntry":
        card = d.get("card")
        return ModelEntry(
            name=d["name"],
            namespace=d["namespace"],
            component=d["component"],
            endpoint=d["endpoint"],
            instance_id=d["instance_id"],
            model_type=d.get("model_type", MODEL_TYPE_CHAT),
            model_input=d.get("model_input", MODEL_INPUT_TOKENS),
            card=ModelDeploymentCard.from_wire(card) if card else None,
        )


async def register_llm(
    runtime,
    endpoint,
    card: ModelDeploymentCard,
    model_types: tuple[str, ...] = (MODEL_TYPE_CHAT, MODEL_TYPE_COMPLETIONS),
    model_input: str = MODEL_INPUT_TOKENS,
    lease_id: Optional[int] = None,
) -> list[ModelEntry]:
    """Register a served model in the KV store under the (primary) lease.

    ref: lib/bindings/python register_llm → etcd models/<slug>/<lease>
    (discovery/model_entry.rs). Frontends watch ``models/`` and build
    pipelines when entries appear.
    """
    lease = lease_id if lease_id is not None else await runtime.primary_lease()
    entries = []
    for mt in model_types:
        entry = ModelEntry(
            name=card.display_name,
            namespace=endpoint.component.namespace.name,
            component=endpoint.component.name,
            endpoint=endpoint.name,
            instance_id=lease,
            model_type=mt,
            model_input=model_input,
            card=card,
        )
        key = entry.key() + f"/{mt}"
        value = packb(entry.to_wire())
        await runtime.plane.kv_put(key, value, lease_id=lease)
        runtime.record_registration(key, value)  # survives hub restarts
        entries.append(entry)
    return entries
