"""Dataclass-driven CLI parsing (the port's copy of
``dalle_tpu/cli/_args.py``).

The reference parses its config dataclasses with ``HfArgumentParser``
(``run_trainer.py:27-28``); this is the same idea on plain argparse: every
field of every config dataclass becomes a ``--flag``, and only flags the
user actually passed override the preset's defaults (so ``--preset tiny``
plus ``--depth 2`` works without re-stating the whole tiny config).
"""

from __future__ import annotations

import argparse
import dataclasses
import typing
from typing import Any, Dict, Optional, Sequence, Type


def _unwrap_optional(tp):
    import types

    origin = typing.get_origin(tp)
    # typing.Union covers Optional[X]; types.UnionType covers PEP 604
    # ``X | None`` annotations — argparse needs the bare callable either way
    if origin is typing.Union or origin is types.UnionType:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def add_dataclass_args(parser: argparse.ArgumentParser, cls: Type,
                       skip: Sequence[str] = ()) -> None:
    """One ``--flag`` per dataclass field; defaults are SUPPRESSed so the
    namespace only contains what the user passed."""
    hints = typing.get_type_hints(cls)
    group = parser.add_argument_group(cls.__name__)
    for f in dataclasses.fields(cls):
        if f.name in skip:
            continue
        flag = "--" + f.name.replace("_", "-")
        tp = _unwrap_optional(hints[f.name])
        origin = typing.get_origin(tp)
        if tp is bool:
            group.add_argument(flag, action=argparse.BooleanOptionalAction,
                               default=argparse.SUPPRESS,
                               help=f"[{cls.__name__}] default {f.default}")
        elif origin is tuple:
            elem = typing.get_args(tp)[0]
            group.add_argument(flag, nargs="*",
                               type=str if elem is str else elem,
                               default=argparse.SUPPRESS,
                               help=f"[{cls.__name__}] default {f.default}")
        else:
            group.add_argument(flag, type=tp, default=argparse.SUPPRESS,
                               help=f"[{cls.__name__}] default {f.default}")


def dataclass_from_args(cls: Type, ns: argparse.Namespace,
                        base: Optional[Any] = None) -> Any:
    """Build ``cls`` from the parsed namespace over ``base``'s defaults."""
    names = {f.name for f in dataclasses.fields(cls)}
    overrides: Dict[str, Any] = {}
    for name in names:
        if hasattr(ns, name):
            value = getattr(ns, name)
            if isinstance(value, list):
                value = tuple(value)
            overrides[name] = value
    if base is not None:
        return dataclasses.replace(base, **overrides)
    return cls(**overrides)


def check_no_collisions(*classes: Type) -> None:
    """Flat namespaces require globally unique field names."""
    seen: Dict[str, str] = {}
    for cls in classes:
        for f in dataclasses.fields(cls):
            if f.name in seen:
                raise ValueError(
                    f"flag collision: {f.name} in both {seen[f.name]} "
                    f"and {cls.__name__}")
            seen[f.name] = cls.__name__
