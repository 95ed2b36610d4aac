"""The readers of the program's own spans and counters
(``molar_tpu_torch.tracing``) on hand-made runs: each value, and None where
its key is missing."""

from __future__ import annotations

import pytest

from portbench.drivers.common import LayerRun
from portbench.harness import spec


def _run(spans):
    return LayerRun(frames=256, window_s=8.0, spans=spans)


@pytest.mark.parametrize("metric,spans,want", [
    ("search_enqueue_ms_per_frame", {"fit_within.search": 2.56}, 10.0),
    ("retry_pct", {"retry": 0.4}, 5.0),
    ("retry_pct.skewed", {"retry": 0.0}, 0.0),
    ("device_allocs_per_window", {"device_allocs": 12, "windows": 4}, 3.0),
    ("device_allocs_per_window.skewed", {"device_allocs": 0, "windows": 1}, 0.0),
    ("sasa_lists_ms_per_frame", {"sasa.lists@device": 0.512, "sasa.lists": 9.0}, 2.0),
    ("sasa_arcs_ms_per_frame", {"sasa.arcs@device": 1.28, "sasa.arcs": 9.0}, 5.0),
])
def test_reader(metric, spans, want):
    assert spec.reader(metric).read(_run(spans)) == pytest.approx(want)


@pytest.mark.parametrize("metric,spans", [
    ("search_enqueue_ms_per_frame", {"enqueue": 1.0}),
    ("retry_pct", {"retried_windows": 0}),
    ("device_allocs_per_window", {"windows": 4}),
    ("device_allocs_per_window", {"device_allocs": 3, "windows": 0}),
    ("sasa_lists_ms_per_frame", {"sasa.lists": 1.0}),
    ("sasa_arcs_ms_per_frame", {"sasa.arcs": 1.0}),
])
def test_reader_without_its_key(metric, spans):
    """The parent of a change that adds a span has no such key: no value."""
    assert spec.reader(metric).read(_run(spans)) is None


def test_every_new_reader_is_listed_in_its_cells():
    """Every ``per_layer`` entry is reported in each cell its ``workloads``
    lists, and its reader resolves by name."""
    bench = spec.load_benchmark()
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]).read), m["name"]
        for cell in m.get("workloads", ()):
            spec.cell(bench, cell)
            assert m["name"] in [x["name"] for x in spec.metrics_of(bench, "per_layer", cell)], \
                (m["name"], cell)
