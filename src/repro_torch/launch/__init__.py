"""Launch layer of the port: the serving CLI (``launch/serve.py``) and the
training driver (``launch/train.py``)."""
