"""One intra-op thread in each process that runs the port's CPU tests.

pytest-xdist runs the suite in several worker processes (the tier-1
command takes six), and a multi-rank test spawns its ranks beside them;
torch's default of one intra-op thread per core in each process
oversubscribes the cores, and a matmul of a few kilobytes then waits
milliseconds at its thread barrier. The port's test modules and the rank
bodies (``torch_mesh_ranks``) import this module, which sets one thread
for the process; what a test computes does not change.
"""
import torch

torch.set_num_threads(1)
