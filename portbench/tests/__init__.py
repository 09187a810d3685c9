"""CPU tests of the benchmark (``python -m pytest portbench/tests``); those
marked ``cuda`` decide inside themselves whether a card is there."""
