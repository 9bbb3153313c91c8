"""The program entries a traffic mix can drive, one module each, found by
the mix's ``entry``."""
