"""One module per kind of system path a configuration drives, named by the
configuration file's ``driver`` key."""
