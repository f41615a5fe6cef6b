"""The port's configs beside the JAX package's. The port's `ModelConfig`
and `SSMConfig` have fields the reference lacks (the mamba_hybrid family's
layer pattern, NoPE, muP multipliers and Mamba-2 sizes); each has a
default that builds the reference's model, so a config of the registry
compares with the reference's on the reference's fields, and holds the
port's own at their defaults."""
import dataclasses


def reference_fields(port, ref):
    """`port` as `dataclasses.asdict(ref)` gives `ref`: the reference's
    fields only, recursing into sub-configs. Raises AssertionError where a
    field that only the port has is not at its default."""
    if not (dataclasses.is_dataclass(port) and dataclasses.is_dataclass(ref)):
        return dataclasses.asdict(port) if dataclasses.is_dataclass(port) \
            else port
    names = [f.name for f in dataclasses.fields(ref)]
    for f in dataclasses.fields(port):
        if f.name not in names:
            assert getattr(port, f.name) == f.default, \
                (type(port).__name__, f.name, getattr(port, f.name))
    return {n: reference_fields(getattr(port, n), getattr(ref, n))
            for n in names}
