"""Config persistence, profiling and spans."""
from .config import (ParameterDict, load_jason_to_dict, load_json_to_dict,
                     save_dict_to_json)
from .profiling import (annotate, device_memory_stats, spans_between, sync,
                        trace)

__all__ = ["ParameterDict", "annotate", "device_memory_stats",
           "load_jason_to_dict", "load_json_to_dict", "save_dict_to_json",
           "spans_between", "sync", "trace"]
