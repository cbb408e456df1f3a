"""Plain references that decide ``correct``: straightforward PyTorch over the
inputs the benchmark made (``rmbench.inputs``).  They import nothing of the
program under test and take nothing it made."""
