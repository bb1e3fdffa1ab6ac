"""The plain references that decide ``correct``. They import nothing of
the program (``tpunav_torch``) nor of ``tpunav``, and take only the
inputs that the benchmark made and the program's outputs to judge."""
