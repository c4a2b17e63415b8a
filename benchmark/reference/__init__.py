"""Plain PyTorch references of what the benchmark's cells compute.

They follow the published model in f32 (TF32 off) and import nothing of the
program: the benchmark hands them the same inputs it hands the program
(weights, codes, UV maps, images, cameras, seeds of the random draws) and
they work everything else out again. `Precision` lets the comparison's
control run the same arithmetic with its products' operands rounded lower.
"""
