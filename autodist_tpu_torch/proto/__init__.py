"""Generated protobuf modules: byte-identical copies of the JAX package's
``strategy_pb2.py`` and ``graphitem_pb2.py``, so a ``Strategy`` or a
``GraphItem`` serialized by either package parses in the other."""
