"""Frozen copies of the program's generator, dropout hash and roofline
arithmetic, so that program changes cannot move the yardstick."""
