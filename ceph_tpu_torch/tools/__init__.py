"""CLI tools (reference layer 7: src/tools/).

crush_test         crushtool --test analog (batched, on the card by default)
ec_benchmark       ceph_erasure_code_benchmark analog (on the card by default)
ec_non_regression  the EC corpus check (the committed tests/golden/ec_corpus)
sass_report        registers and item-loop SASS of the CUDA kernels (on the
                   card)
"""
