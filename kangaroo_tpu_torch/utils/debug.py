"""Debug / sanitizer mode (``kangaroo_tpu/utils/debug.py``).

The reference's debugging story is GPU_CHECK_ERRORS_SYNC — a
cudaDeviceSynchronize after every launch (launch_utils.h:7-44) — plus NaN
sentinels flowing through every image. The JAX package wires JAX's two
mechanisms (``jax_debug_nans`` and checkify) behind this module's names;
here both are ``TorchFunctionMode``s, which see each call of a torch
function or tensor method (as JAX sees each primitive, and not the ATen
ops a composite such as ``torch.isfinite`` runs inside), with the same
semantics:

* ``debug_mode(True)`` / ``debug_mode(False)`` (call style) and
  ``with debug_mode():`` (scoped, restores the previous state) — every op
  whose floating output holds a NaN raises ``FloatingPointError`` naming
  the op ("invalid value (nan) encountered in log"), a NaN only propagated
  from an input included (``[1, nan] + 1`` raises, ``log(-1)`` raises,
  ``1 / 0`` = inf does not). The switch is the calling thread's: PyTorch
  keeps function modes per thread.
* :func:`checked` — ``checked(fn)(*args)`` returns ``(err, out)``;
  ``err.get()`` is None or a message: that of the first
  :func:`assert_all_finite` that failed ("depth contains non-finite values
  (`check` failed)"), else that of the first of these in program order: a
  NaN in an op's output ("nan generated by primitive: log."), a division
  with a zero divisor ("division by zero"). As checkify does: a failed
  assertion wins over a NaN made before it. ``err.throw()`` raises the
  message as ``ValueError`` (the base of the JAX package's
  ``JaxRuntimeError``).
  Overflow to inf is not recorded. Each condition is kept as a device flag
  and read at ``get()``, so ``fn`` runs without host synchronisations.
  Out-of-bounds indexing and an integer division by zero raise in
  PyTorch without it.

NaN is data in this framework: invalid disparities and invalid depth are
NaN. So a normal stereo or KinectFusion frame raises under ``debug_mode``,
as it does under ``jax_debug_nans``; code under this mode must route the
sentinels through masks before an op produces them.

Three things are not seen. The factories of uninitialised memory
(``empty``, ``empty_like``, ``empty_strided``, ``new_empty``, ``resize_``)
and attribute reads (``.grad``, ``.data``) are not checked: their bytes
may hold NaN patterns that nothing computed. Ops that return nothing
(``x[i] = nan``) have no output to check. The CUDA kernels of ``csrc/``
write their outputs through ctypes, outside torch: a NaN a kernel writes
is seen by the next op that reads it, not at the kernel's return.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch
from torch.overrides import TorchFunctionMode

# factories whose outputs hold whatever the allocator handed back, and
# attribute reads
_UNCHECKED = {"empty", "empty_like", "empty_strided", "empty_permuted", "new_empty",
              "new_empty_strided", "resize_", "__get__"}
# divisions: the divisor is the second argument, or the tensor itself for
# the reflected forms (``1 / x``) and reciprocal
_DIVISIONS = {"div", "div_", "divide", "divide_", "true_divide", "true_divide_", "__truediv__",
              "__itruediv__", "__floordiv__", "__ifloordiv__", "floor_divide", "floor_divide_",
              "remainder", "remainder_", "__mod__", "__imod__", "fmod", "fmod_"}
_DIVIDE_BY_SELF = {"__rdiv__", "__rtruediv__", "__rfloordiv__", "__rmod__", "reciprocal",
                   "reciprocal_"}

_tls = threading.local()


def _name(func) -> str:
    """The op's name as the messages give it: ``add`` for ``x + 1``, ``div``
    for ``1 / x``."""
    name = getattr(func, "__name__", str(func))
    if name.startswith("__") and name.endswith("__"):
        name = name[2:-2]
        if name[:1] in "ri" and name[1:] in {"add", "sub", "mul", "div", "truediv", "floordiv",
                                             "mod", "pow", "matmul", "and", "or", "xor"}:
            name = name[1:]
    return name


def _float_outputs(out):
    if isinstance(out, torch.Tensor):
        out = (out,)
    if not isinstance(out, (tuple, list)):
        return []
    return [t for t in out if isinstance(t, torch.Tensor) and t.device.type != "meta"
            and (t.is_floating_point() or t.is_complex())]


def _any_nan(outputs):
    """A 0-d bool tensor: any NaN in ``outputs`` (on the first one's device)."""
    flags = [torch.isnan(t).any() for t in outputs]
    return functools.reduce(lambda a, b: a | b.to(a.device), flags)


def _checked_outputs(func, out):
    if getattr(func, "__name__", None) in _UNCHECKED:
        return []
    return _float_outputs(out)


class _RaiseOnNan(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outputs = _checked_outputs(func, out)
        if outputs and bool(_any_nan(outputs)):
            raise FloatingPointError(f"invalid value (nan) encountered in {_name(func)}")
        return out


def _set(enable: bool) -> None:
    mode = getattr(_tls, "mode", None)
    if enable and mode is None:
        mode = _RaiseOnNan()
        mode.__enter__()
        _tls.mode = mode
    elif not enable and mode is not None:
        mode.__exit__(None, None, None)
        _tls.mode = None


class debug_mode(contextlib.ContextDecorator):
    """Raise on every NaN an op outputs, switched for the calling thread
    (call style) or scoped (with style).

    >>> debug_mode(True)         # until debug_mode(False)
    >>> with debug_mode(): ...   # scoped
    """

    def __init__(self, enable: bool | None = None):
        self._prev = None
        if enable is not None:
            _set(bool(enable))

    def __enter__(self):
        self._prev = getattr(_tls, "mode", None) is not None
        _set(True)
        return self

    def __exit__(self, *exc):
        _set(self._prev)
        return False


class CheckError:
    """The first failed check of a :func:`checked` call, read at ``get``."""

    def __init__(self):
        # (flag, message) in program order: the assertions, the float checks
        self._records: tuple[list, list] = ([], [])
        self._msg: str | None = None
        self._read = False

    def _record(self, flag, msg: str, user: bool = False) -> None:
        self._records[0 if user else 1].append((flag, msg))

    def get(self) -> str | None:
        """None, or the message of the first check that failed."""
        if not self._read:
            self._msg = next((msg for records in self._records for flag, msg in records
                              if bool(flag)), None)
            self._records, self._read = ([], []), True
        return self._msg

    def throw(self) -> None:
        """Raise ``ValueError`` with the first failure's message, if any."""
        msg = self.get()
        if msg is not None:
            raise ValueError(msg)


class _Record(TorchFunctionMode):
    def __init__(self, err: CheckError):
        super().__init__()
        self.err = err

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", None)
        if name in _DIVISIONS or name in _DIVIDE_BY_SELF:
            divisor = (args[0] if name in _DIVIDE_BY_SELF
                       else args[1] if len(args) > 1 else kwargs.get("other"))
            zero = (divisor == 0).any() if isinstance(divisor, torch.Tensor) else divisor == 0
            self.err._record(zero, "division by zero")
        out = func(*args, **kwargs)
        outputs = _checked_outputs(func, out)
        if outputs:
            self.err._record(_any_nan(outputs), f"nan generated by primitive: {_name(func)}.")
        return out


def checked(fn):
    """Wrap ``fn``: the wrapper returns ``(err, out)``, ``err`` a
    :class:`CheckError` recording the first NaN output, division by zero or
    failed :func:`assert_all_finite` of the call (see the module
    docstring)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        err = CheckError()
        stack = _tls.__dict__.setdefault("checks", [])
        stack.append(err)
        try:
            with _Record(err):
                out = fn(*args, **kwargs)
        finally:
            stack.pop()
        return err, out

    return wrapper


def assert_all_finite(x, name: str = "value"):
    """Check that every element of ``x`` is finite — a guard for pipeline
    boundaries where NaN must mean 'invalid pixel', never 'poisoned math'.
    Inside :func:`checked` the failure is recorded; outside it raises
    ``ValueError`` at once."""
    msg = f"{name} contains non-finite values (`check` failed)"
    with torch._C.DisableTorchFunction():  # the check's own ops are not checked
        bad = ~torch.isfinite(torch.as_tensor(x)).all()
    checks = getattr(_tls, "checks", None)
    if checks:
        checks[-1]._record(bad, msg, user=True)
    elif bool(bad):
        raise ValueError(msg)
