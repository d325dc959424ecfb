"""Core numerical ops: basis and mesh tables, per-element residuals, the
Gauss-Newton assemblies, small-block algebra and the CUDA kernels'
wrappers with their plain versions."""
