"""The benchmark's plain reference: frozen copies of the port's host oracle
(``nfa/``) and its query front end (``pattern/``, ``compiler/stages.py``,
``utils/events.py``), importing nothing of the program."""
