"""One experiment's Gauss-Newton system from the model's values at the nodes:
the CUDA kernel's wrapper, its plain version, and the dispatch that picks it.

:func:`ops.assemble.assemble_gn_soa` builds the damped-GN system of an
:class:`~collocfem_tpu_torch.problem.EstimationProblem` in one of two ways:

  * the element-level path: ``vmap(jacfwd(elem_residual))`` over the
    elements, the normal-equation einsums and the chain scatter, for any
    problem on any device;
  * this module's: the model's values and first derivatives only where the
    residual needs them (:func:`node_values`: f, df/dx and df/dp at each
    collocated node, h, dh/dx and dh/dp at each sample, by
    ``vmap(jacfwd(...))`` over nx + nq tangents), then the hand-written
    kernel ``csrc/gn_elements.cu`` (:func:`gn_system`), which builds each
    element's residual and Jacobian from the structure of
    ``elem_residual`` and writes D, E, B, C, gx, gp and the float64 cost
    straight into the SoA chain.

:func:`engages` picks this module's path where it can observe that it
holds: CUDA tensors, ``elem_residual`` not overridden, a shape in the
kernel's range (:func:`kernel_supports`), and ``meas_w`` and ``x0_w`` of a
form the kernel reads.  :func:`gn_system_ref` is the kernel's plain
version: the same Jacobian built from the same node values, in PyTorch.
The library is built at its first use for each shape (``ops._build``,
instance ``gn_elements`` at b = d nx, r = nq and the degree, samples per
element, outputs and defect rule); a shape outside the range raises
ValueError before any launch.  Each function counts its calls
(``.launches``; the wrapper also by (b, nq) in ``.shapes``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from collocfem_tpu_torch.ops import _build

MAX_NQ = 16
SMEM_LIMIT = 200 * 1024   # csrc/gn_elements.cu kSmemLimit


def kernel_supports(degree: int, nx: int, nq: int, samples: int, ny: int,
                    full: bool) -> bool:
    """Whether the kernel takes the shape: chain block d nx <= 16, 1 <= nq
    <= 16, S >= 1, ny >= 1, and 32 elements' [J | r] (rows (d or d + 1) nx
    + S ny, columns (d + 1) nx + nq + 1) with their parameter sums fit a
    block's shared memory in float64."""
    if not (degree >= 1 and nx >= 1 and degree * nx <= _build.MAX_BLOCK
            and 1 <= nq <= MAX_NQ and samples >= 1 and ny >= 1):
        return False
    rows = (degree + bool(full)) * nx + samples * ny
    cols = (degree + 1) * nx + nq + 1
    pp = nq * (nq + 1) // 2 + nq
    return 32 * ((rows * cols + pp) * 8 + 8) <= SMEM_LIMIT   # float64


def instance(degree: int, nx: int, nq: int, samples: int, ny: int,
             full: bool) -> _build.Instance:
    """The library instance at the shape; raises ValueError, naming the
    range, for a shape the kernel does not take."""
    if not kernel_supports(degree, nx, nq, samples, ny, full):
        raise ValueError(
            f"the GN element kernel takes d nx <= {_build.MAX_BLOCK}, 1 <= "
            f"nq <= {MAX_NQ}, S >= 1, ny >= 1 and a tile of 32 elements' "
            f"Jacobians within {SMEM_LIMIT} bytes, not d={degree}, nx={nx}, "
            f"nq={nq}, S={samples}, ny={ny}, full={bool(full)}")
    return _build.Instance("gn_elements", degree * nx, nq, (
        ("D", degree), ("S", samples), ("NY", ny), ("FULL", int(full))))


class _Call(ctypes.Structure):
    """csrc/gn_elements.cu ``Call``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "V", "fv", "fx", "fp", "hv", "hx", "hp",
        "y", "w", "mask", "rows", "widths", "dscale", "diff",
        "p", "p_prior", "p_w", "x0_prior", "x0_w",
        "D", "E", "B", "gx", "C", "gp", "cost", "part", "rr_part")] + [
        (name, ctypes.c_longlong) for name in (
            "w_e", "w_s", "w_o", "n", "x0_full")]


@functools.cache
def _library(inst: _build.Instance) -> ctypes.CDLL:
    """The instance, built at its first use and loaded."""
    lib = _build.load(inst).lib
    i32 = ctypes.c_int
    for name in ("gn_elements_f32", "gn_elements_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_Call), ctypes.c_void_p]
        fn.restype = i32
    lib.gn_elements_tile.argtypes = [i32]
    lib.gn_elements_tile.restype = i32
    lib.gn_elements_error_string.argtypes = [i32]
    lib.gn_elements_error_string.restype = ctypes.c_char_p
    return lib


class NodeValues(NamedTuple):
    """The model at the collocated nodes (DD = d, or d + 1 for the 'full'
    rule) and at the samples, element-major: fv (N, DD, nx), fx (N, DD, nx,
    nx), fp (N, DD, nx, nq); hv (N, S, ny), hx (N, S, ny, nx), hp (N, S,
    ny, nq)."""

    fv: torch.Tensor
    fx: torch.Tensor
    fp: torch.Tensor
    hv: torch.Tensor
    hx: torch.Tensor
    hp: torch.Tensor


def _value_and_jacobian(fn):
    """vmap over points of (fn, d fn/dx, d fn/dp) at (x, u, p, t), p
    shared: ((jx, jp), value)."""
    def both(x, u, p, t):
        out = fn(x, u, p, t)
        return out, out

    return vmap(jacfwd(both, argnums=(0, 2), has_aux=True),
                in_dims=(0, 0, None, 0))


def node_values(problem, z, data) -> NodeValues:
    """The model's values and first derivatives where the residual needs
    them: f at each collocated node (local nodes 1..d of each element, each
    global node after node 0 once; all d + 1 for the 'full' rule), h at
    each sample point, whose state and input are explicit sums over the
    element's d + 1 interpolation rows.  Each comes in the iterate's dtype:
    jacfwd of a model's arithmetic with a Python float (the aircraft's h)
    gives float64 derivatives of float32 inputs."""
    model, mesh = problem.model, problem.mesh
    n, d = mesh.num_elements, mesh.degree
    nx, nu, nq, ny = model.nx, model.nu, model.nq, model.ny
    s = problem.mmask.shape[1]
    xe = problem.gather_elements(z.V).reshape(n, d + 1, nx)
    if problem.defect_rule == "full":
        dd, xn, un, tn = d + 1, xe, data.u, problem.elem_times
    else:
        dd, xn = d, z.V[1:].reshape(n, d, nx)
        un, tn = data.u[:, 1:], problem.elem_times[:, 1:]
    (fx, fp), fv = _value_and_jacobian(model.f)(
        xn.reshape(n * dd, nx), un.reshape(n * dd, nu), z.p,
        tn.reshape(n * dd))
    rows = problem.mrows.unsqueeze(-1)                     # (N, S, d+1, 1)
    x_s = (rows * xe.unsqueeze(1)).sum(-2)
    u_s = (rows * data.u.unsqueeze(1)).sum(-2)
    (hx, hp), hv = _value_and_jacobian(model.h)(
        x_s.reshape(n * s, nx), u_s.reshape(n * s, nu), z.p,
        problem.mtimes.reshape(n * s))
    shapes = ((n, dd, nx), (n, dd, nx, nx), (n, dd, nx, nq), (n, s, ny),
              (n, s, ny, nx), (n, s, ny, nq))
    return NodeValues(*(x.to(z.V.dtype).reshape(shape).contiguous()
                        for x, shape in zip((fv, fx, fp, hv, hx, hp),
                                            shapes)))


def element_jacobians(problem, z, data, vals: NodeValues):
    """Every element's residual r (N, m), Jx (N, m, (d + 1) nx) and Jp (N,
    m, nq) from the node values, by the structure of ``elem_residual``:
    what the kernel builds in shared memory."""
    mesh, model = problem.mesh, problem.model
    n, d, nx = mesh.num_elements, mesh.degree, model.nx
    nq, ny = model.nq, model.ny
    s = problem.mmask.shape[1]
    full = problem.defect_rule == "full"
    dd, k0 = (d + 1, 0) if full else (d, 1)
    diff = problem.diff
    # d/dX of diff (X - X_0): column 0 becomes -sum_{j >= 1} diff[:, j].
    deff = torch.cat([-diff[:, 1:].sum(1, keepdim=True), diff[:, 1:]], 1)
    alpha = (2.0 / problem.widths)[:, None, None]           # (N, 1, 1)
    xe = problem.gather_elements(z.V).reshape(n, d + 1, nx)
    xdot = alpha * torch.einsum("kj,ejn->ekn", diff[k0:], xe - xe[:, :1])
    sc = problem.dscale                                     # (N, DD, nx)
    r_def = (xdot - vals.fv) * sc
    eye = torch.eye(nx, dtype=sc.dtype, device=sc.device)
    # (N, DD, nx rows i, d + 1 nodes j, nx states l)
    jx_def = alpha[..., None, None] * deff[k0:, None, :, None] * \
        eye[None, None, :, None, :]
    own = torch.zeros_like(jx_def)
    for kk in range(dd):
        own[:, kk, :, kk + k0, :] = vals.fx[:, kk]
    jx_def = (jx_def - own) * sc[..., None, None]
    jp_def = -vals.fp * sc[..., None]
    g = data.meas_w.expand(n, s, ny) * problem.mmask[..., None]  # (N, S, ny)
    r_meas = (vals.hv - data.y) * g
    jx_meas = (vals.hx[:, :, :, None, :]
               * problem.mrows[:, :, None, :, None]) * g[..., None, None]
    jp_meas = vals.hp * g[..., None]
    r = torch.cat([r_def.reshape(n, dd * nx), r_meas.reshape(n, s * ny)], 1)
    jx = torch.cat([jx_def.reshape(n, dd * nx, (d + 1) * nx),
                    jx_meas.reshape(n, s * ny, (d + 1) * nx)], 1)
    jp = torch.cat([jp_def.reshape(n, dd * nx, nq),
                    jp_meas.reshape(n, s * ny, nq)], 1)
    return r, jx, jp


def gn_system_ref(problem, z, data, vals: NodeValues):
    """Plain version of the kernel: (the SoA system, the float64 cost) from
    :func:`element_jacobians` through the element-level path's normal
    equations and chain scatter."""
    from collocfem_tpu_torch.ops.assemble import normal_equations_soa

    gn_system_ref.launches += 1
    r, jx, jp = element_jacobians(problem, z, data, vals)
    return normal_equations_soa(problem, z, data, r, jx, jp, with_cost=True)


_build.register(gn_system_ref, shapes=False)


def _strides(w) -> tuple[int, int, int]:
    """meas_w's (element, sample, output) strides: (ny,) or (N, S, ny)."""
    if w.dim() == 1:
        return 0, 0, w.stride(0)
    return w.stride(0), w.stride(1), w.stride(2)


def gn_system(problem, z, data, vals: NodeValues):
    """The kernel on CUDA tensors: (the SoA system, the float64 cost 0.5
    ||r||^2 with the priors').  Raises ValueError before any launch on a
    shape or operand the kernel does not take."""
    from collocfem_tpu_torch.ops.assemble import BlockTriSystemSoA

    mesh, model = problem.mesh, problem.model
    n, d, nx = mesh.num_elements, mesh.degree, model.nx
    nq, ny = model.nq, model.ny
    s = problem.mmask.shape[1]
    full = problem.defect_rule == "full"
    dd, bd, k = d + full, d * nx, n + 1
    V, w = z.V, data.meas_w
    if V.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {V.device}")
    x0_full = data.x0_w.dim() == 2
    ops = [("V", V, (n * d + 1, nx)), ("fv", vals.fv, (n, dd, nx)),
           ("fx", vals.fx, (n, dd, nx, nx)), ("fp", vals.fp, (n, dd, nx, nq)),
           ("hv", vals.hv, (n, s, ny)), ("hx", vals.hx, (n, s, ny, nx)),
           ("hp", vals.hp, (n, s, ny, nq)), ("y", data.y, (n, s, ny)),
           ("meas_w", w, (ny,) if w.dim() == 1 else (n, s, ny)),
           ("mask", problem.mmask, (n, s)),
           ("rows", problem.mrows, (n, s, d + 1)),
           ("widths", problem.widths, (n,)),
           ("dscale", problem.dscale, (n, dd, nx)),
           ("diff", problem.diff, (d + 1, d + 1)), ("p", z.p, (nq,)),
           ("p_prior", data.p_prior, (nq,)), ("p_w", data.p_w, (nq,)),
           ("x0_prior", data.x0_prior, (nx,)),
           ("x0_w", data.x0_w, (nx, nx) if x0_full else (nx,))]
    _build.check_operands(ops, contiguous=[name for name, _, _ in ops
                                           if name != "meas_w"])
    lib = _library(instance(d, nx, nq, s, ny, full))
    f64 = V.dtype == torch.float64
    blocks = -(-k // (lib.gn_elements_tile(int(f64)) - 1))
    D = V.new_empty((bd, bd, k))
    E = V.new_empty((bd, bd, k))
    B = V.new_empty((bd, nq, k))
    gx = V.new_empty((bd, k))
    C = V.new_empty((nq, nq))
    gp = V.new_empty((nq,))
    cost = V.new_empty((), dtype=torch.float64)
    part = V.new_empty((blocks, nq * (nq + 1) // 2 + nq))
    rr_part = V.new_empty((blocks,), dtype=torch.float64)
    tensors = dict(
        V=V, fv=vals.fv, fx=vals.fx, fp=vals.fp, hv=vals.hv, hx=vals.hx,
        hp=vals.hp, y=data.y, w=w, mask=problem.mmask, rows=problem.mrows,
        widths=problem.widths, dscale=problem.dscale, diff=problem.diff,
        p=z.p, p_prior=data.p_prior, p_w=data.p_w, x0_prior=data.x0_prior,
        x0_w=data.x0_w, D=D, E=E, B=B, gx=gx, C=C, gp=gp, cost=cost,
        part=part, rr_part=rr_part)
    w_e, w_s, w_o = _strides(w)
    call = _Call(**{name: x.data_ptr() for name, x in tensors.items()},
                 w_e=w_e, w_s=w_s, w_o=w_o, n=n, x0_full=int(x0_full))
    fn = lib.gn_elements_f64 if f64 else lib.gn_elements_f32
    with torch.cuda.device(V.device):
        rc = fn(ctypes.byref(call),
                torch.cuda.current_stream(V.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("gn_elements launch failed: "
                           + lib.gn_elements_error_string(rc).decode())
    _build.count_launches(gn_system, (bd, nq))
    return BlockTriSystemSoA(D=D, E=E, B=B, C=C, gx=gx, gp=gp), cost


_build.register(gn_system, shapes=True)


def in_range(problem, data) -> bool:
    """Whether the kernel takes ``problem`` with ``data``: an
    :class:`EstimationProblem` whose ``elem_residual`` is the class's own,
    a shape in the kernel's range (:func:`kernel_supports`), a shared (ny,)
    or per-sample (N, S, ny) ``meas_w`` and a per-state (nx,) or full (nx,
    nx) ``x0_w``."""
    from collocfem_tpu_torch.problem import EstimationProblem

    if getattr(type(problem), "elem_residual", None) is not \
            EstimationProblem.elem_residual:
        return False
    model = problem.model
    n, s = problem.mmask.shape
    nx, ny = model.nx, model.ny
    return (problem.nv == nx
            and kernel_supports(problem.mesh.degree, nx, model.nq, s, ny,
                                problem.defect_rule == "full")
            and tuple(data.meas_w.shape) in ((ny,), (n, s, ny))
            and tuple(data.x0_w.shape) in ((nx,), (nx, nx)))


def engages(problem, z, data) -> bool:
    """Whether :func:`ops.assemble.assemble_gn_soa` takes this module's
    path: CUDA tensors and :func:`in_range`."""
    return z.V.device.type == "cuda" and in_range(problem, data)
