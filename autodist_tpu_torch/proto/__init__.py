"""Generated protobuf modules: a byte-identical copy of the JAX package's
``strategy_pb2.py``, so a ``Strategy`` serialized by either package parses
in the other."""
