"""The multi-stage (v2) engine: joins and window functions, on one
device. Port of ``pinot_tpu/multistage`` without the networked stage
plane (``dispatch.py``)."""
from .relation import Relation  # noqa: F401
from .executor import (execute_multistage, explain_multistage,  # noqa: F401
                       is_multistage)
