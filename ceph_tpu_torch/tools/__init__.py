"""CLI tools (reference layer 7: src/tools/).

crush_test         crushtool --test analog (batched, on the card by default)
crushtool          crushtool -c / -d / --tree / --build (text.py, map_codec)
osdmap_test        osdmaptool --test-map-pgs analog, through the context's
                   mapping service (on the card by default)
psim               the placement simulator, through the mapping service
ec_benchmark       ceph_erasure_code_benchmark analog (on the card by default)
ec_non_regression  the EC corpus check (the committed tests/golden/ec_corpus)
sass_report        registers and item-loop SASS of the CUDA kernels (on the
                   card)
"""
