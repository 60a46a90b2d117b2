"""One driver per kind of traffic mix, named by the mix's ``driver`` key."""
