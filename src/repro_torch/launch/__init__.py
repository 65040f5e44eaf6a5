"""Launch layer of the port: the serving CLI (``launch/serve.py``), the
training CLI (``launch/train.py``) and the production and smoke meshes
(``launch/mesh.py``)."""
