"""Per-peer training metrics published through the DHT (counterpart of
``dalle_tpu/swarm/metrics.py``).

Capability parity with the reference's monitoring records (``utils.py:15-30``
defines a strict ``LocalMetrics``/``MetricSchema`` pair; ``callback.py:60-86``
signs and stores one record per epoch under ``{experiment_prefix}_metrics``;
``run_aux_peer.py:106-144`` aggregates them).

:func:`make_validators` wires the same two defenses the reference installs
at ``task.py:55`` — a signature validator whose public key is the peer
identity, with the metrics key *protected* (unsigned records dropped), and a
schema validator rejecting malformed values — so the aux peer only ever
aggregates authenticated, well-formed metrics.

The JAX package validates a record with a pydantic model; the port has no
pydantic, so :class:`LocalMetrics` is a frozen dataclass whose
:meth:`LocalMetrics.model_validate` accepts and refuses the same decoded
records as pydantic v2's lax mode: extra or missing fields are refused; an
int field takes an int, a bool, an integral float below 2**63 in magnitude,
or a decimal string as pydantic-core reads one (leading zeros and
underscores stripped, after which a ``-`` may still open the number; then
a JSON integer, with single underscores between digits; an optional
``.0…`` tail); a float field takes an int, a bool, a float or a
float string (``inf``/``nan`` spellings too); a str field takes a str or
UTF-8 bytes. Strings are stripped of whitespace first, and bytes are
decoded as UTF-8. ``tests/test_torch_swarm.py`` holds the two validators
against each other.
"""

from __future__ import annotations

import dataclasses
import math
import re
from dataclasses import dataclass
from typing import Any, Dict, List

from dalle_tpu_torch.swarm.dht import (DHT, RecordValidatorBase,
                                       SchemaValidator, SignatureValidator,
                                       get_dht_time)
from dalle_tpu_torch.swarm.identity import Identity


class ValidationError(ValueError):
    """A record that the schema refuses."""


_JSON_INT = re.compile(r"-?(?:0|[1-9][0-9]*)")
_DECIMAL_ZEROS = re.compile(r"(.*)\.0+", re.S)
_FLOAT_CHARS = re.compile(r"[0-9A-Za-z+\-._]+")
# Unicode White_Space, the characters pydantic-core trims (Rust's
# ``str::trim``); Python's ``str.strip()`` would also take \x1c-\x1f.
_WHITESPACE = ("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003"
               "\u2004\u2005\u2006\u2007\u2008\u2009\u200a\u2028\u2029"
               "\u202f\u205f\u3000")


def _text(value: Any) -> str:
    if isinstance(value, (bytes, bytearray)):
        try:
            return bytes(value).decode("utf-8")
        except UnicodeDecodeError:
            raise ValidationError("invalid UTF-8") from None
    return value


def _strip_zeros(body: str):
    if not body or body[0] in "123456789":
        return body or None
    if body[0] != "0":
        return None
    for i in range(1, len(body)):
        if body[i] in "0_":
            continue
        return body[i:] if body[i] in "123456789-" else None
    return body[-1]


def _int_text(text: str):
    """pydantic-core's ``str_as_int`` on trimmed text: leading zeros (and
    underscores among them) go first, so ``'0-1'`` reads as -1; what is
    left is a JSON integer, with its underscores dropped if each lies
    between two characters."""
    if text[:1] in ("+", "-") and text:
        rest = _strip_zeros(text[1:])
        text = None if rest is None else text[0].lstrip("+") + rest
    else:
        text = _strip_zeros(text)
    if text is None:
        return None
    if (_JSON_INT.fullmatch(text) is None and "_" in text
            and not ("__" in text or text[0] == "_" or text[-1] == "_")):
        text = text.replace("_", "")
    return int(text) if _JSON_INT.fullmatch(text) else None


def _as_int(value: Any) -> int:
    if isinstance(value, bool):
        return int(value)
    if isinstance(value, int):
        return value
    if isinstance(value, float):
        if (math.isfinite(value) and value == math.floor(value)
                and abs(value) < 2.0 ** 63):
            return int(value)
        raise ValidationError(f"not an integral number: {value!r}")
    if isinstance(value, (str, bytes, bytearray)):
        text = _text(value).strip(_WHITESPACE)
        number = _int_text(text)
        tail = _DECIMAL_ZEROS.fullmatch(text)
        if number is None and tail is not None:
            number = _int_text(tail.group(1))
        if number is not None:
            return number
        raise ValidationError(f"not an integer string: {text!r}")
    raise ValidationError(f"not an integer: {type(value).__name__}")


def _as_float(value: Any) -> float:
    if isinstance(value, (bool, int, float)):
        return float(value)
    if isinstance(value, (str, bytes, bytearray)):
        raw = _text(value)
        text = raw.strip(_WHITESPACE)
        if (not _FLOAT_CHARS.fullmatch(text) or text.startswith("_")
                or text.endswith("_") or "__" in text
                or ("_" in text and text != raw)):
            raise ValidationError(f"not a float string: {text!r}")
        try:
            return float(text.replace("_", ""))
        except ValueError:
            raise ValidationError(f"not a float string: {text!r}") from None
    raise ValidationError(f"not a float: {type(value).__name__}")


def _as_str(value: Any) -> str:
    if isinstance(value, str):
        return value
    if isinstance(value, (bytes, bytearray)):
        return _text(value)
    raise ValidationError(f"not a string: {type(value).__name__}")


_COERCE = {int: _as_int, float: _as_float, str: _as_str}


@dataclass(frozen=True)
class LocalMetrics:
    """One peer's per-epoch report (reference ``utils.py:15-21``), with
    the robustness counters of ``CollaborativeOptimizer
    .robustness_snapshot()`` (each 0 by default, so records without them
    stay valid)."""

    peer_id: str
    epoch: int
    samples_per_second: float
    samples_accumulated: int
    loss: float
    mini_steps: int
    parts_audited: int = 0
    audit_convictions: int = 0
    repairs_applied: int = 0
    repair_ring_evictions: int = 0
    ef_lost_rounds: int = 0
    proofs_published: int = 0
    proofs_convicted: int = 0
    proofs_rejected: int = 0

    @classmethod
    def model_validate(cls, obj: Any) -> "LocalMetrics":
        """The record ``obj`` (a decoded DHT value) as a
        :class:`LocalMetrics`; raises :class:`ValidationError`."""
        if not isinstance(obj, dict):
            raise ValidationError("a metrics record must be a map")
        fields = {f.name: f for f in dataclasses.fields(cls)}
        extra = [k for k in obj if not isinstance(k, str) or k not in fields]
        if extra:
            raise ValidationError(f"unexpected fields {extra!r}")
        values: Dict[str, Any] = {}
        for name, f in fields.items():
            if name not in obj:
                if f.default is dataclasses.MISSING:
                    raise ValidationError(f"missing field {name!r}")
                continue
            values[name] = _COERCE[_FIELD_TYPES[name]](obj[name])
        return cls(**values)

    def model_dump(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


_FIELD_TYPES = {"peer_id": str, "epoch": int, "samples_per_second": float,
                "samples_accumulated": int, "loss": float,
                "mini_steps": int, "parts_audited": int,
                "audit_convictions": int, "repairs_applied": int,
                "repair_ring_evictions": int, "ef_lost_rounds": int,
                "proofs_published": int, "proofs_convicted": int,
                "proofs_rejected": int}


def metrics_key(experiment_prefix: str) -> str:
    return f"{experiment_prefix}_metrics"


def make_validators(identity: Identity, experiment_prefix: str
                    ) -> List[RecordValidatorBase]:
    """The standard validator chain for a peer (reference ``utils.py:27-30``,
    wired at ``task.py:55,111``)."""
    return [
        SchemaValidator({metrics_key(experiment_prefix): LocalMetrics}),
        SignatureValidator(
            identity, protected_keys=(metrics_key(experiment_prefix),)),
    ]


def publish_metrics(dht: DHT, experiment_prefix: str, record: LocalMetrics,
                    expiration: float = 600.0) -> bool:
    """Store this peer's epoch report (reference ``callback.py:80-86``)."""
    return dht.store(
        metrics_key(experiment_prefix), dht.peer_id,
        record.model_dump(), expiration_time=get_dht_time() + expiration)


def fetch_metrics(dht: DHT, experiment_prefix: str
                  ) -> List[LocalMetrics]:
    """All live peers' latest reports (reference ``run_aux_peer.py:107-118``).

    Forged or malformed records were already dropped by the validator chain
    on read; anything that still fails to parse is skipped defensively.
    """
    entries = dht.get(metrics_key(experiment_prefix)) or {}
    out: List[LocalMetrics] = []
    for subkey, item in entries.items():
        bound = dht.bound_peer_id(subkey)
        if bound is None:
            continue  # spoofed identity binding
        try:
            m = LocalMetrics.model_validate(item.value)
        except ValidationError:
            continue
        if m.peer_id != bound:
            continue
        out.append(m)
    return out


def peer_data_seed(identity: Identity, base_seed: int = 0) -> int:
    """Per-peer shuffle seed derived from the peer identity (reference
    ``run_trainer.py:46``: ``data_seed=hash(local_public_key)``)."""
    return base_seed ^ int.from_bytes(identity.public_bytes[:8], "big")
