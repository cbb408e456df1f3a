"""Drivers, one a kind of work, found by the name a configuration gives
(``"driver"``): each has ``run(cell, seed, seconds, trace, device, clock)
-> result.Outcome``."""
