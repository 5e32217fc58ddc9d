"""Mesh and sharding helpers (``mesh_utils``) and host-level fault
tolerance (``fault``): retry, straggler and elastic policies, as in
``repro.distributed``."""

from .mesh_utils import axis_size, flat_devices, spec  # noqa: F401
from .fault import (AttemptTimeout, ElasticPolicy, RetryPolicy,  # noqa: F401
                    StragglerMonitor)
