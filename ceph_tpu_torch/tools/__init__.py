"""CLI tools (reference layer 7: src/tools/).

crush_test      crushtool --test analog (batched, on the card by default)
sass_report     registers and item-loop SASS of the CUDA kernels (on the card)
"""
