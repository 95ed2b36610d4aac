from . import measure_host, neighbor_host

__all__ = ["measure_host", "neighbor_host"]
