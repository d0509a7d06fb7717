"""The loops that drive a cell's window, one module per traffic ``loop``.

Each module's ``Loop(cell, device, seed, timer)`` makes the cell's inputs
from the seed and offers: ``kind`` ("train" or "serve"), ``calibrate()``,
``warm()`` (the first steps or views, through the window's own call; a
training loop records what the check compares), ``op()`` (one step or
view: a device flag, nonzero when the op failed), ``free()``, ``check()``
({number: value} against the reference), ``control()`` (the same with
the reference in bfloat16 in the program's place) and ``work()`` (the
counts the per-layer readers need).  A serving loop also has ``rate``
(views due a second) and ``keep(i)`` (it keeps the sampled answers).
"""
