"""Plain references the benchmark judges the program's outputs against.

Numpy, scipy and plain torch only: nothing here imports the program
(arterynetwork_tpu_torch), the JAX package or JAX, and nothing takes a
table, weight or derived array that the program made.
"""
