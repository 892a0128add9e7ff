"""Data and sequence parallelism over ``torch.distributed``, one process
per GPU: the ('data', 'model') mesh (``mesh.py``), launch detection
(``launch.py``), the collectives with their autograd rules
(``comm.py``), the halo-exchanged temporal shift (``halo.py``) and the
T-sharded model and steps (``seqpar.py``)."""
