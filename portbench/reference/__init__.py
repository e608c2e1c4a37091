"""The plain reference the benchmark judges the program by.

Plain PyTorch in float32 (the heads' matmuls in the configuration's
bfloat16), written from the published equations and from the port's plain
versions as they stood when the benchmark was defined.  It imports nothing
of the program and takes none of its weights, grids or tables: the
benchmark hands it the same inputs it hands the program.
"""
