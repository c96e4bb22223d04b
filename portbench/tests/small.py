"""Cells shrunk to run on the CPU in a test: the same files and code, at
small image sizes and capacities."""

A = "colmap-sift-3200.pairs"
B = "tum-fr1-vga.extract-b256"
SHRINK = {
    A: {"config": {"image": {"height": 120, "width": 160},
                   "sift": {"max_keypoints": 256,
                            "max_keypoints_per_octave": 256},
                   "match": {"max_matches": 256},
                   "ransac": {"num_hypotheses": 64},
                   "scene": {"pairs": 2}}},
    B: {"config": {"image": {"height": 96, "width": 128},
                   "scene": {"frames": 8}},
        "traffic": {"batch": 4}},
}
SEED = 2**31 + 12345
