"""Stage 2's hetcor CI tests a second at its combinatorial levels >= 4
(``skeleton/cupc.py``): the tests of ``ci_tests_level`` at levels >= 4 over
the sum of those levels' ``level_wall_s``, summed over the window's solves.
None where the program counts no tests by level, or stage 2 reached no
level 4."""

FIRST = 4


def read(run):
    tests, wall = 0, 0.0
    for s in run.stats:
        st = s.get("stage2", {})
        if "ci_tests_level" not in st:
            return None
        tests += sum(n for l, n in st["ci_tests_level"].items() if l >= FIRST)
        wall += sum(w for l, w in st.get("level_wall_s", {}).items() if l >= FIRST)
    return tests / wall if tests and wall > 0 else None
