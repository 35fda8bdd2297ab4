"""Plain references, one per model family, named by a configuration's
``reference`` key."""
