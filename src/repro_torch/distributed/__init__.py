"""Host-level fault tolerance (``fault``): retry, straggler and elastic
policies, as in ``repro.distributed.fault``."""
