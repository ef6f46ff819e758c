"""Traffic drivers, one file a kind (`<kind>.py`), and traffic mixes, one
data file each (`<name>.json`, naming its kind). A driver holds `setup`,
`window`, `stretch_units`, `step_kernels`, `free`, `reference` and
`compare` (see `portbench/harness.py`)."""
