"""One engine over a grid of devices: the mesh (mesh.py) and the sharded
engine steps (sharded.py) that TorchEngine dispatches when
Config.mesh_shape gives it more than one device."""
