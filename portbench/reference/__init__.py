"""Plain PyTorch references, one module per architecture form, named by
the ``reference`` key of a configuration's file.  They import nothing of
the program."""
