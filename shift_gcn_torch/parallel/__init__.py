"""Data, sequence and tensor parallelism and the edge partition over
``torch.distributed``, one process per GPU: the ('data', 'model') mesh
(``mesh.py``), launch detection (``launch.py``), the collectives with
their autograd rules (``comm.py``), the halo-exchanged temporal shift
(``halo.py``), the sharded output channels (``tensor.py``), the
attached model and its steps (``seqpar.py``), and the graph's edges or
nodes over the model ranks (``edge_partition.py``)."""
