"""The yardstick's arithmetic, frozen here so that later changes to the
program cannot move it: the H100's published peaks (``peaks.py``), each
kernel's operations and bytes counted from the shapes of the work its
inputs need (``flash_attention.py``, ``ssm_scan.py``), and each block
kind's model FLOPs and bytes for a step (``<kind>.py``, found by the kind's
name), whatever implements them."""
