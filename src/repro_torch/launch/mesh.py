"""Production mesh factory, as ``repro.launch.mesh``.

A FUNCTION, not a module-level constant: importing this module touches no
process-group state.  Single pod: 16×16 = 256 devices (data, model).
Multi-pod: 2×16×16 = 512 devices (pod, data, model).  The dry run brings
up a fake process group of that many ranks first.
"""

from __future__ import annotations

from repro_torch.distributed import mesh as meshlib


def production_shape(multi_pod: bool = False):
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    shape, axes = production_shape(multi_pod)
    return meshlib.make_mesh(shape, axes, device_type)
