"""Drivers: one module per kind of configuration, named by its file's
``driver`` key.  Each defines ``MODES`` and ``Driver(config, traffic,
seed, device, mode="sound")`` with:

- ``setup()``: build the program's objects, make the inputs from the seed,
  warm up every shape the window uses (all counted as set-up);
- ``unit() -> int``: one timed unit of work, read back as the program's
  own loop reads it; returns the work it completed (the unit of the cell's
  rate);
- ``end_to_end(t0, ends) -> {metric: value}`` from the window's start and
  each unit's end (host clock);
- ``counters() -> dict``: counts the per-layer readers take;
- ``release()``: drop the program's state, keeping what ``check`` compares;
- ``check() -> [(name, value, limit)]``: the plain reference's comparison;
- ``attempted``, ``failed``: units run, and those whose output was not
  finite;
- ``check_units``: after ``setup``, the units whose outputs together are
  every answer a run compares (for ``calibrate.py``).

``mode`` is for ``calibrate.py`` alone: ``sound`` (a run) is the program as
the configuration states it; every other mode in the driver's ``MODES`` is
the control or a fault, which the driver sets up itself (the program with
its own lower-precision path on, or the plain reference put in the
program's place in ``release``), so that ``check`` reads what the control or
the fault does to the compared numbers.
"""
