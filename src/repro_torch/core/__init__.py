"""The semantic-operator layer of the port: accounting, the oracle and
embedder backends, and the operators (slice 1: ``operators/search.py``)."""
