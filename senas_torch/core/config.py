"""YAML config loader with the reference schema.

A copy of `senas_tpu/core/config.py`, kept here so that the PyTorch port
imports nothing of the JAX package.

The shipped configs (configs/senas/*.yml) use `!!python/tuple` for Adam betas
(reference configs/senas/senas_promise12.yml:36, loaded with yaml.FullLoader
at experiments/search_arc.py:47). We support that tag without allowing
arbitrary python object construction.
"""

from __future__ import annotations

from typing import Any, Dict

import yaml


class _SenasLoader(yaml.SafeLoader):
    pass


def _construct_python_tuple(loader, node):
    return tuple(loader.construct_sequence(node))


_SenasLoader.add_constructor("tag:yaml.org,2002:python/tuple", _construct_python_tuple)


def load_config(path: str) -> Dict[str, Any]:
    with open(path, "r") as fp:
        return yaml.load(fp, Loader=_SenasLoader)

