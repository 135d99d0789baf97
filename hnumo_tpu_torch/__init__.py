"""PyTorch/CUDA port of the multilayer shallow-water core (hnumo_tpu).

Same layout and names as the JAX package so a reader finds the counterpart
of every module; imports torch and numpy only. Importing the package never
compiles anything: the CUDA kernel is built at its first launch.
"""
