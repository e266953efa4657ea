"""The model families: one package each, ``portbench/models/<model>/``,
found by a configuration's ``model`` (``portbench/loops.py`` gives what a
family holds)."""
