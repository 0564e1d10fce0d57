"""The most frames a session of the window took to its first published
pose (a monocular session's two-view initialization). A session before the
window's last that published none never initialized and reads inf; the
last, which the window's close may have cut, reads the frames submitted in
it. A compared number as a later cell adds it: `checks/<name>.py` of the
harness, which imports nothing of the program."""


def number(ctx):
    win = ctx.win
    first = win.first_pose()
    worst = 0.0
    for s in range(win.session + 1):
        if s in first:
            worst = max(worst, first[s])
        elif s < win.session:
            return float("inf")
        else:
            worst = max(worst, sum(1 for ss, _ in win.submitted if ss == s))
    return float(worst)
