"""Plain references of the configurations' models, named by their ``reference`` key."""
