"""The port's protocol errors against the JAX package's.

``smi_tpu_torch/parallel/errors.py`` keeps the two classes of the JAX
``parallel/credits.py`` that the port raises: the same bases, constructor
and fields, so a handler written for one package's verified transport
catches the other's errors alike.
"""

import inspect

import pytest

from smi_tpu.parallel import credits as J
from smi_tpu_torch.parallel import errors as E


@pytest.mark.parametrize("name", ["ProtocolError", "IntegrityError"])
def test_error_has_the_jax_classes_bases_and_constructor(name):
    port, jax_cls = getattr(E, name), getattr(J, name)
    assert [c.__name__ for c in port.__mro__] == [
        c.__name__ for c in jax_cls.__mro__]
    def params(cls):
        return [(p.name, p.kind, p.default) for p in
                inspect.signature(cls.__init__).parameters.values()]

    assert params(port) == params(jax_cls)


@pytest.mark.parametrize("args,kwargs", [
    (("bare",), {}),
    (("checksum miss",), dict(rank=6, src=5, seq=304, expected=0x1234abcd,
                              got=-7, kind="checksum")),
    (("reorder",), dict(rank=1, src=0, seq=3, expected=2, got=3,
                        kind="sequence")),
    (("positional", 2, 1, 9, 11, 12, "checksum"), {}),
])
def test_integrity_error_keeps_the_jax_message_and_fields(args, kwargs):
    got, want = E.IntegrityError(*args, **kwargs), J.IntegrityError(
        *args, **kwargs)
    assert str(got) == str(want) and got.args == want.args
    for field in ("rank", "src", "seq", "expected", "got", "kind"):
        assert getattr(got, field) == getattr(want, field), field


def test_the_package_exports_the_transports_error():
    import smi_tpu_torch as st
    from smi_tpu_torch.parallel import channels

    assert st.IntegrityError is E.IntegrityError is channels.IntegrityError
    with pytest.raises(AssertionError):
        raise E.IntegrityError("caught as the protocol's assertion")
