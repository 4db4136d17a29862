"""The precisions a configuration's program file can run its program in.

Each program file (`perfbench/programs/<config>.py`) binds its
`set_precision` to one of these, or defines its own: it accepts the
precision its configuration states, or refuses it before anything runs.
"""

from __future__ import annotations


def float32(cfg: dict) -> None:
    """float32, with cuDNN's and cuBLAS's TF32 as the configuration's
    `allow_tf32` sets them (PyTorch leaves cuDNN's on by default)."""
    if cfg["precision"] != "float32":
        raise NotImplementedError(f"{cfg['name']}: precision {cfg['precision']!r}; this "
                                  "program file runs float32 only")
    import torch
    tf32 = bool(cfg["allow_tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
