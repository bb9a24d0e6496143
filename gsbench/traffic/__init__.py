"""Traffic: each mix is a data file `<traffic>.json` here, named by a cell's
`traffic`; its `kind` names the module `<kind>.py` here that drives it. A
driver module has `KERNELS` (the port's kernels it builds in set-up),
`FAULTS`, `APPLIED` (the configuration keys it applies), `run(...)` (one run
of a cell, `harness.run_cell`), and for the check's calibration `readings`,
`reference`, `compare` and `control`; a driver that spawns ranks has each
enter `control.replant()` first and gathers them into one record as
`harness.py` states (`gsbench/README.md` has the whole contract). A new
mix of a known kind is a new data file; a new kind is a new module.
"""
