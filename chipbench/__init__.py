"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``): one
command runs one cell once (``chipbench/run.py``); configurations, traffic,
metric readers, the plain reference and the yardstick's arithmetic each in
files of their own, found by name."""
