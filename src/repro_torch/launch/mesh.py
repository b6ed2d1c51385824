"""Production meshes; port of `repro/launch/mesh.py`.

Functions, never module-level constants, so importing this module
touches no device."""
from __future__ import annotations

from repro_torch.configs.base import MULTI_POD, SINGLE_POD, MeshSpec
from repro_torch.sharding.rules import Mesh, make_mesh_from_spec


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """(16,16) = 256 devices ('data','model'); multi-pod: (2,16,16).
    `devices` as `make_mesh_from_spec` takes them (default: every
    visible CUDA device, so one card raises)."""
    return make_mesh_from_spec(production_mesh_spec(multi_pod=multi_pod),
                               devices)


def production_mesh_spec(*, multi_pod: bool = False) -> MeshSpec:
    return MULTI_POD if multi_pod else SINGLE_POD
