"""The analysis plane's runtime half: the lock-order watchdog
(`lockorder.make_lock`), through which the store and the write coalescer
build their locks. The static lint suite is not ported yet.

This __init__ stays import-light on purpose: importing the package must
cost nothing beyond the stdlib.
"""
