"""Config persistence, profiling and throughput observability."""
from .config import (ParameterDict, load_jason_to_dict, load_json_to_dict,
                     save_dict_to_json)
from .profiling import (ThroughputMeter, annotate, device_memory_stats, sync,
                        trace)

__all__ = ["ParameterDict", "ThroughputMeter", "annotate",
           "device_memory_stats", "load_jason_to_dict", "load_json_to_dict",
           "save_dict_to_json", "sync", "trace"]
