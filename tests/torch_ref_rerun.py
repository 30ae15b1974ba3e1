"""Re-run a reference test function against the port (not a test module).

:func:`load_reference` loads a JAX test file as a private module (its
own copy: the reference run is untouched); :class:`Both` stands in for
one of its module aliases (``T``, ``P``, ``native``): every call goes to
the JAX module and to the port's with the same arguments, the port's
result (or raised error) must equal the JAX one's, and the JAX result is
returned, so the reference test's own assertions hold too.
:func:`run_reference` calls a reference test with its fixtures.
"""

import dataclasses
import enum
import importlib.util
import inspect
import os

TESTS = os.path.dirname(os.path.abspath(__file__))


def load_reference(name: str):
    """A private copy of ``tests/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", os.path.join(TESTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def norm(v):
    """A package-neutral form of a result: the JAX package's and the
    port's objects of the same name and fields normalize alike."""
    if isinstance(v, enum.Enum):
        return ("enum", type(v).__name__, norm(v.value))
    if isinstance(v, dict):
        return {repr(norm(k)): norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [norm(x) for x in v]
    if isinstance(v, (set, frozenset)):
        return sorted(repr(norm(x)) for x in v)
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__, norm(
            {f.name: getattr(v, f.name) for f in dataclasses.fields(v)}))
    if hasattr(v, "__dict__") and not callable(v):
        return (type(v).__name__, norm(vars(v)))
    return v


class Both:
    """Calls ``jax_mod.f`` and ``port_mod.f`` alike; names in ``skip``
    are only called (their results may differ by design). An error must
    be raised by both, of one type and, with ``messages``, one
    message."""

    def __init__(self, jax_mod, port_mod, skip=(), messages=True):
        self._jax, self._port, self._skip = jax_mod, port_mod, set(skip)
        self._messages = messages
        self.calls = []

    def __getattr__(self, name):
        jv, pv = getattr(self._jax, name), getattr(self._port, name)
        if not callable(jv) or isinstance(jv, type):
            if not callable(jv):
                assert norm(pv) == norm(jv), name
            return jv

        def call(*args, **kwargs):
            self.calls.append(name)
            jerr = perr = None
            try:
                jres = jv(*args, **kwargs)
            except Exception as e:  # the port must raise alike
                jerr = e
            try:
                pres = pv(*args, **kwargs)
            except Exception as e:
                perr = e
            if jerr is not None or perr is not None:
                assert type(perr).__name__ == type(jerr).__name__, name
                if self._messages:
                    assert str(perr) == str(jerr), name
                raise jerr
            if name not in self._skip:
                assert norm(pres) == norm(jres), name
            return jres
        return call


def run_reference(fn, request):
    """Call the reference test ``fn``, its fixtures taken from pytest."""
    kwargs = {p: request.getfixturevalue(p)
              for p in inspect.signature(fn).parameters}
    return fn(**kwargs)
