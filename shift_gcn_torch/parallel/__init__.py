"""Data, sequence and tensor parallelism over ``torch.distributed``, one
process per GPU: the ('data', 'model') mesh (``mesh.py``), launch
detection (``launch.py``), the collectives with their autograd rules
(``comm.py``), the halo-exchanged temporal shift (``halo.py``), the
sharded output channels (``tensor.py``) and the attached model and its
steps (``seqpar.py``)."""
