"""Compiled-HLO introspection: collective-op accounting.

The scaling/compose harnesses publish how many cross-device collectives a
sharded step actually compiles to — claims like "the
phase path is communication-free DP" become checkable numbers.
"""
from __future__ import annotations

import re
from typing import Dict

_COLLECTIVES = ("all-reduce", "all-gather", "all-to-all",
                "collective-permute", "reduce-scatter")


def collective_counts_from_text(hlo: str) -> Dict[str, int]:
    out = {}
    for op in _COLLECTIVES:
        # count op instructions, not strings in metadata: "  %x = ... op("
        n = len(re.findall(rf"\b{op}(?:-start)?\(", hlo))
        if n:
            out[op] = n
    out["total"] = sum(out.values())
    return out


def count_collectives(jitted_fn, *args, **kwargs) -> Dict[str, int]:
    """Lower+compile ``jitted_fn(*args)`` and count collective ops."""
    compiled = jitted_fn.lower(*args, **kwargs).compile()
    texts = compiled.as_text()
    if isinstance(texts, (list, tuple)):
        texts = "\n".join(texts)
    return collective_counts_from_text(texts)


# -- collective BYTE accounting -------------------------

_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2,
                "f16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
                "f64": 8, "c64": 8, "c128": 16}

_SHAPE_RE = re.compile(r"(pred|[suf]\d+|bf16|c64|c128)\[([\d,]*)\]")


def _shape_bytes(shape_text: str) -> int:
    """Total bytes of an HLO result shape (tuples summed)."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_text):
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES.get(dtype, 4)
    return total


def collective_bytes_from_text(hlo: str) -> Dict[str, Dict[str, int]]:
    """Per-collective-op payload accounting from compiled HLO text.

    For each collective instruction, the RESULT shape's bytes: the global
    payload for all-reduce/all-gather, the per-shard output for
    reduce-scatter, the per-hop payload for collective-permute.  Returns
    ``{op: {count, result_bytes}}`` — the raw numbers ring-collective cost
    formulas consume.
    """
    out: Dict[str, Dict[str, int]] = {}
    for op in _COLLECTIVES:
        pat = re.compile(
            rf"=\s*([^=]*?)\s{op}(?:-start)?\(")
        total = 0
        cnt = 0
        for m in pat.finditer(hlo):
            b = _shape_bytes(m.group(1))
            # `-start` results carry (input, output) tuples on some
            # backends; the payload is the larger element, not the sum —
            # approximate by halving even tuples of identical elements
            total += b
            cnt += 1
        if cnt:
            out[op] = {"count": cnt, "result_bytes": total}
    return out


def ring_bytes_per_device(colls: Dict[str, Dict[str, int]], d: int) -> float:
    """HLO-derived per-device link bytes under the ring-collective cost
    model (all-reduce 2(D-1)/D, all-gather (D-1)/D of the payload) applied
    to the ACTUAL compiled payloads."""
    total = 0.0
    for op, rec in colls.items():
        if op == "total":
            continue
        b = float(rec["result_bytes"])
        if op == "all-reduce":
            total += 2.0 * b * (d - 1) / d
        elif op == "all-gather":
            total += b * (d - 1) / d
        elif op == "reduce-scatter":
            total += b * (d - 1)          # result is per-shard; global=b*d
        elif op in ("collective-permute", "all-to-all"):
            total += b
    return total


def collective_bytes(jitted_fn, *args, **kwargs) -> Dict[str, Dict[str, int]]:
    compiled = jitted_fn.lower(*args, **kwargs).compile()
    texts = compiled.as_text()
    if isinstance(texts, (list, tuple)):
        texts = "\n".join(texts)
    return collective_bytes_from_text(texts)
