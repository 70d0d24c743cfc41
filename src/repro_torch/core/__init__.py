"""The semantic-operator layer of the port: accounting, langex, the oracle
and embedder backends, and the operators (``operators/search.py``,
``operators/topk.py``)."""
