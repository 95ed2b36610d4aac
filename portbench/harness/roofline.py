"""A part's share of its roofline, with the bound that sets it and the card's
power limit written beside it."""

from __future__ import annotations

from ..frozen import bounds


def share(run, part: str, name: str):
    """100 x the least time of ``run.work(part)`` over ``run.device_ms(part)``,
    or None where the run has no such part."""
    ms, w = run.device_ms(part), run.work(part)
    if ms is None or w is None:
        return None
    least, bound = bounds.least_seconds(w["flops"], w["bytes"])
    value = 100.0 * least / (ms / 1e3)
    run.notes.append(f"{name}: {value:.6g} % bound by {bound} (least {least * 1e3:.6g} ms, "
                     f"measured {ms:.6g} ms, {w['flops']:.6g} FLOPs, {w['bytes']:.6g} bytes, "
                     f"{w['items']} items) on {run.card}")
    return value
