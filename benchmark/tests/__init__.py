"""The harness's own tests: CPU at tiny sizes, plus one marked ``gpu`` that
runs a cell on the card. From the checkout's root:

    python -m pytest benchmark/tests -q
"""
