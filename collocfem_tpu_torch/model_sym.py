"""Symbolic model front end: declare dynamics as sympy expressions.

Counterpart of ``collocfem_tpu/model_sym.py``.  Expressions are parsed with
sympy and lambdified against torch, so the callables are plain tensor code:
they run under ``torch.func.vmap`` and ``jacfwd`` like a hand-written
``Model``, and inside the solvers' CUDA graphs.  Every component comes back
as a tensor of the state's dtype and device: a constant component (a Python
number from lambdify) is filled on the device.  The lambdified functions
take each symbol as a one-element tensor, not a 0-d one: ``jacfwd`` of 0-d
arithmetic with a Python number (``x0 - 2.0``, ``2.5*x0``) returns float64
Jacobians for float32 inputs, and on one-element tensors it keeps the
working dtype.

Example::

    VdP = symbolic_model(
        name="VanDerPolSym",
        states="x0 x1",
        inputs="u0",
        params="mu b",
        f=["x1", "mu*(1 - x0**2)*x1 - x0 + b*u0"],
        h=["x0"],
    )
    model = VdP()          # a collocfem_tpu_torch.model.Model subclass

Expressions may reference the state, input and parameter names and ``t``
(time).  Optional groups mirror the ``Model`` protocol: ``h`` (outputs),
``g`` (inequality path constraints, <= 0), ``g_eq`` (equality path
constraints), ``running_cost_residual`` and ``terminal_cost_residual``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from collocfem_tpu_torch.model import Model


def _names(spec) -> list[str]:
    """'a b c' | ['a', 'b', 'c'] -> list of identifier strings."""
    if spec is None:
        return []
    if isinstance(spec, str):
        out = spec.replace(",", " ").split()
    else:
        out = [str(s) for s in spec]
    for n in out:
        if not n.isidentifier():
            raise ValueError(f"symbol name {n!r} is not a valid identifier")
    if len(set(out)) != len(out):
        raise ValueError(f"duplicate symbol names in {out}")
    return out


def _parse(exprs, local_dict):
    import sympy

    if isinstance(exprs, str):
        exprs = [exprs]
    return [sympy.sympify(e, locals=local_dict) if isinstance(e, str) else e
            for e in exprs]


def _compile_group(exprs, syms, local_dict):
    """Parse and lambdify a list of scalar expressions against torch.

    Returns ``(fn, n)``: ``fn(like, *args) -> (n,)`` tensor in ``like``'s
    dtype and on its device, each arg a (1,) tensor, or (None, 0) for an
    empty group.
    """
    import sympy

    if exprs is None:
        return None, 0
    parsed = _parse(exprs, local_dict)
    free = set().union(*(e.free_symbols for e in parsed)) if parsed else set()
    unknown = [str(s) for s in free - set(local_dict.values())]
    if unknown:
        raise ValueError(
            f"expression uses undeclared symbols {sorted(unknown)}; declare "
            "them in states/inputs/params (time is 't')")
    fns = [sympy.lambdify(syms, e, modules="torch") for e in parsed]

    def fn(like, *args):
        vals = [f(*args) for f in fns]
        return torch.cat([v.to(like.dtype).expand(1) if torch.is_tensor(v)
                          else like.new_full((1,), float(v)) for v in vals])

    return fn, len(parsed)


def symbolic_model(
    name: str,
    states,
    f: Sequence,
    inputs=None,
    params=None,
    h=None,
    g=None,
    g_eq=None,
    running_cost_residual=None,
    terminal_cost_residual=None,
):
    """Build a ``Model`` subclass from sympy expressions.

    Each group is a list of expressions (strings or sympy expressions), one
    scalar per component; see the module docstring for the names an
    expression may use.  Returns the new class (instantiate with no
    arguments).
    """
    import sympy

    st, inp, par = _names(states), _names(inputs), _names(params)
    names = st + inp + par
    if "t" in names or len(names) != len(set(names)):
        raise ValueError("state/input/param names must be distinct and not "
                         "'t'")
    syms = {n: sympy.Symbol(n, real=True) for n in names + ["t"]}
    args = tuple(syms[n] for n in names + ["t"])

    f_fn, nf = _compile_group(f, args, syms)
    if nf != len(st):
        raise ValueError(f"f has {nf} components but there are {len(st)} "
                         "states")
    h_fn, _ = _compile_group(h, args, syms)
    g_fn, ng = _compile_group(g, args, syms)
    ge_fn, ne = _compile_group(g_eq, args, syms)
    rc_fn, _ = _compile_group(running_cost_residual, args, syms)
    tc_fn, _ = _compile_group(terminal_cost_residual, args, syms)
    if terminal_cost_residual is not None:
        # Model.terminal_cost_residual(x, p) has no input or time argument:
        # expressions using them are refused, not bound to zeros.
        used = {str(s) for e in _parse(terminal_cost_residual, syms)
                for s in e.free_symbols}
        bad = used & (set(inp) | {"t"})
        if bad:
            raise ValueError(
                "terminal_cost_residual may not reference inputs or 't' "
                "(the base Model.terminal_cost_residual(x, p) has no time "
                f"argument): {sorted(bad)}")

    nx, nu, nq = len(st), len(inp), len(par)

    def call(fn, x, u, p, t):
        t = t.reshape(1) if torch.is_tensor(t) else x.new_full((1,), float(t))
        return fn(x, *(x[i:i + 1] for i in range(nx)),
                  *(u[i:i + 1] for i in range(nu)),
                  *(p[i:i + 1] for i in range(nq)), t)

    ns = {
        "__doc__": f"Symbolically defined model {name!r} "
                   f"(states={st}, inputs={inp}, params={par}).",
        "nx": nx, "nu": nu, "nq": nq, "ng": ng, "ne": ne,
        "state_names": tuple(st), "input_names": tuple(inp),
        "param_names": tuple(par),
        "f": lambda self, x, u, p, t: call(f_fn, x, u, p, t),
    }
    for key, fn in (("h", h_fn), ("g", g_fn), ("g_eq", ge_fn),
                    ("running_cost_residual", rc_fn)):
        if fn is not None:
            ns[key] = lambda self, x, u, p, t, fn=fn: call(fn, x, u, p, t)
    if tc_fn is not None:
        ns["terminal_cost_residual"] = lambda self, x, p: call(
            tc_fn, x, x.new_zeros((nu,)), p, 0.0)
    return type(name, (Model,), ns)
