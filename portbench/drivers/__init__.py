"""One module per traffic kind, named by the ``kind`` key of a traffic
file: ``Load(params, seed, vocab)`` makes the requests from the file's
parameters and the seed, sends what set-up admits (``setup``) and drives
the session one step at a time (``step``), so a new arrival pattern is a
new module here and never an edit to ``core/``."""
