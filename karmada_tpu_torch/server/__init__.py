"""The port's HTTP entry points: the scheduler sidecar shim
(scheduler_shim.py) and the plumbing it shares with the reference's
servers (httpbase.py, wirecodec.py)."""
