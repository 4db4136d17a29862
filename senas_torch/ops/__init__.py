"""The port's ops. `channel_shuffle` is exported here, as the JAX
package's `ops/__init__.py` exports its own; the import is deferred so
that loading a submodule (e.g. `ops._build`) does not load the op
vocabulary."""


def __getattr__(name):
    if name == "channel_shuffle":
        from senas_torch.ops.primitives import channel_shuffle
        return channel_shuffle
    raise AttributeError(f"module 'senas_torch.ops' has no attribute {name!r}")
