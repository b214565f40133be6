"""Loop drivers: ``setup``, ``window`` and ``check`` of one kind of
traffic (see ``port_bench/bench.py``)."""
