"""Debug guards: NaN/inf checking through the solves.

Counterpart of ``collocfem_tpu/utils/debugging.py``.  The JAX package wraps
a jitted function with ``checkify.float_checks``; here :func:`checkified`
runs the function eagerly under a ``TorchDispatchMode`` that looks at the
output of every aten op, and :func:`assert_all_finite` checks a pytree
after the fact.  Both read every value back to the host: they are for
debugging, not for production paths.
"""

from __future__ import annotations

import functools

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import keystr, tree_flatten, tree_flatten_with_path


class FloatCheckError:
    """The result of a checked call: the first failed check, if any."""

    def __init__(self, message: str | None = None):
        self._message = message

    def get(self) -> str | None:
        """The first failed check's message, or None when every op passed."""
        return self._message

    def throw(self) -> None:
        """Raise ``FloatingPointError`` at the first failed check."""
        if self._message is not None:
            raise FloatingPointError(self._message)


def _floats(tree):
    return [t for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor) and t.is_floating_point()]


class _FloatChecks(TorchDispatchMode):
    """Record the first aten op whose output holds a NaN, or an inf made out
    of finite inputs (a division by zero, an overflow): the checks of
    ``checkify.float_checks``.  Ops without a floating tensor input (constants
    and factories, such as the LM loop's initial gradient norm of inf) are the
    caller's own values and are not checked, as JAX does not check
    literals.  Ops inside a ``vmap`` / ``jacfwd`` transform are not checked
    either (:class:`_Transforms` marks them: their tensors belong to the
    transform and cannot be read there); a NaN made inside one is reported
    at the first op after it that reads the transform's result."""

    def __init__(self):
        super().__init__()
        self.message = None
        self.in_transform = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.message is None and not self.in_transform:
            ins, outs = _floats((args, kwargs)), _floats(out)
            if ins and outs:
                nan = any(bool(torch.isnan(t).any()) for t in outs)
                born_inf = (
                    not any(bool(torch.isinf(t).any()) for t in ins)
                    and any(bool(torch.isinf(t).any()) for t in outs))
                if nan or born_inf:
                    self.message = (f"{'nan' if nan else 'inf'} generated "
                                    f"by {func}")
        return out


class _Transforms(TorchFunctionMode):
    """Set ``checks.in_transform`` while a torch function runs inside a
    functorch transform (below the dispatcher the transform's layers are
    popped, so only this level can tell)."""

    def __init__(self, checks: _FloatChecks):
        super().__init__()
        self.checks = checks

    def __torch_function__(self, func, types, args=(), kwargs=None):
        before = self.checks.in_transform
        self.checks.in_transform = before or (
            torch._C._functorch.peek_interpreter_stack() is not None)
        try:
            return func(*args, **(kwargs or {}))
        finally:
            self.checks.in_transform = before


def checkified(fn):
    """Wrap ``fn`` with NaN/inf checking.

    Returns ``wrapped(*args) -> (error, out)``: ``error.throw()`` raises
    ``FloatingPointError`` naming the first aten op whose floating output
    holds a NaN, or an inf made from finite inputs; ``error.get()`` returns
    that message or None.  A captured solve runs through its eager loop
    (``fn.eager``), so every op is seen.

    Example::

        solve_dbg = checkified(make_gn_solver(problem, opts))
        err, (z, stats) = solve_dbg(z0, data)
        err.throw()
    """
    run = getattr(fn, "eager", fn)

    @functools.wraps(run)
    def wrapped(*args, **kwargs):
        checks = _FloatChecks()
        with _Transforms(checks), checks:
            out = run(*args, **kwargs)
        return FloatCheckError(checks.message), out

    return wrapped


def assert_all_finite(tree, name: str = "pytree") -> None:
    """Raise ``FloatingPointError`` naming, by path, every floating leaf of
    ``tree`` that holds a NaN or an inf."""
    bad = [keystr(path) for path, leaf in tree_flatten_with_path(tree)[0]
           if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
           and not bool(torch.isfinite(leaf).all())]
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")
