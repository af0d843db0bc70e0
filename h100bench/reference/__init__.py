"""The plain reference of the benchmark's cells, in PyTorch and NumPy.

It imports nothing of the program. It works out the correlation panel, the
PC-stable (or hetcor) skeleton of both stages and the reductions between
them again from the inputs that the benchmark generated, in float64 (or in
a lower precision for the control), and reads the program's output files
only to judge them.
"""
