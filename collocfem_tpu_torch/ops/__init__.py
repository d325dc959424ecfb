"""Core numerical ops: basis and mesh tables, per-element residuals, the
Gauss-Newton assembly, small-block algebra and the fused KKT kernel."""
