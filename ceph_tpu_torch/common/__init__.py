"""Foundation pieces the port's layers share.

lockdep  named locks and runtime lock-order checking (a copy of the
         reference's common/lockdep.py: pure Python, no device code).
"""
