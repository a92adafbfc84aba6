"""Plain references, one module a model family, named by a
configuration's ``reference`` key."""
