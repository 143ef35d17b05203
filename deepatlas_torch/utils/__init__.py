"""Config persistence and throughput observability."""
from .config import save_dict_to_json
from .profiling import ThroughputMeter, sync

__all__ = ["ThroughputMeter", "save_dict_to_json", "sync"]
