"""Solver layer: plain chain solves, the damped KKT solve and the
Levenberg-Marquardt driver."""
