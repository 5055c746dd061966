"""The share of a step's teacher calls (the program's `sds.teacher` spans)
that replayed the teacher's CUDA graphs (its `teacher.replay` spans), in %;
None where the program opens none of `teacher.replay`, `teacher.capture`
and `teacher.eager`, and so does not say how its teacher ran."""

from portbench import spanread


def read(trace):
    calls = spanread.intervals(trace, "sds.teacher")
    replays = spanread.intervals(trace, "teacher.replay")
    told = replays or spanread.intervals(trace, "teacher.capture") \
        or spanread.intervals(trace, "teacher.eager")
    if not calls or not told:
        return None
    return 100.0 * len(replays) / len(calls)
