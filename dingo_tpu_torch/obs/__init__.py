"""Observability planes of the port: QoS admission and pressure
(``pressure.py``) and the kernel launch-and-shape sentinel
(``sentinel.py``)."""
