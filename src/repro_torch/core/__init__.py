"""The semantic-operator layer of the port: accounting, langex, the oracle
and embedder backends, the operators (``operators/``), their optimizer
(``optimizer/``), the lazy plan layer (``plan/``) and ``frame.SemFrame``."""
