"""Hierarchical task tracker: structured concurrency for the runtime, the
port's copy of ``dynamo_tpu/runtime/tasks.py``.

- A tree of trackers: cancelling or joining a parent covers every child.
- ``spawn`` registers a task with an :class:`OnErrorPolicy` deciding what
  an unhandled exception does: log-and-continue, cancel this tracker's
  scope, or trip a process-wide shutdown callback (critical tasks).
- ``join(graceful_timeout)`` waits for inflight work, then cancels
  stragglers: the graceful-shutdown drain.
- An optional semaphore bounds concurrent tasks per tracker.
"""

from __future__ import annotations

import asyncio
import enum
import logging
from typing import Callable, Optional

logger = logging.getLogger("dynamo.tasks")


class OnErrorPolicy(enum.Enum):
    #: log the exception, keep everything else running (default)
    CONTINUE = "continue"
    #: cancel every task in this tracker (and its children)
    CANCEL_SCOPE = "cancel_scope"
    #: invoke the root's shutdown callback — the process must exit
    SHUTDOWN = "shutdown"


class TaskTracker:
    def __init__(self, name: str = "root",
                 max_concurrency: Optional[int] = None,
                 on_shutdown: Optional[Callable] = None,
                 parent: Optional["TaskTracker"] = None):
        self.name = name
        self._tasks: set[asyncio.Task] = set()
        self._children: list[TaskTracker] = []
        self._parent = parent
        self._sem = (asyncio.Semaphore(max_concurrency)
                     if max_concurrency else None)
        self._on_shutdown = on_shutdown
        self._closed = False
        self.errors = 0

    # -- hierarchy -----------------------------------------------------------

    def child(self, name: str,
              max_concurrency: Optional[int] = None) -> "TaskTracker":
        c = TaskTracker(f"{self.name}/{name}", max_concurrency, parent=self)
        # a child born after join() inherits the drained state — otherwise
        # its spawns would escape the structured-concurrency guarantee
        c._closed = self._closed
        self._children.append(c)
        return c

    def _root_shutdown(self):
        node: TaskTracker = self
        while node._parent is not None and node._on_shutdown is None:
            node = node._parent
        if node._on_shutdown is not None:
            node._on_shutdown()
        else:
            logger.error("tracker %s: SHUTDOWN policy fired but no shutdown "
                         "callback is installed at the root", self.name)

    # -- spawning ------------------------------------------------------------

    def spawn(self, coro, name: str = "task",
              on_error: OnErrorPolicy = OnErrorPolicy.CONTINUE) -> asyncio.Task:
        """Track a coroutine; its failure is handled per ``on_error``."""
        if self._closed:
            coro.close()
            raise RuntimeError(f"tracker {self.name} is closed")

        async def run():
            try:
                if self._sem is not None:
                    async with self._sem:
                        return await coro
                return await coro
            except asyncio.CancelledError:
                coro.close()  # cancelled before first await: don't leak it
                raise

        task = asyncio.get_running_loop().create_task(run(), name=name)
        self._tasks.add(task)

        def done(t: asyncio.Task):
            self._tasks.discard(t)
            if t.cancelled():
                return
            exc = t.exception()
            if exc is None:
                return
            self.errors += 1
            logger.error("tracker %s: task %s failed: %r",
                         self.name, name, exc)
            if on_error is OnErrorPolicy.CANCEL_SCOPE:
                self.cancel_all()
            elif on_error is OnErrorPolicy.SHUTDOWN:
                self._root_shutdown()

        task.add_done_callback(done)
        return task

    # -- lifecycle -----------------------------------------------------------

    @property
    def inflight(self) -> int:
        return (len([t for t in self._tasks if not t.done()])
                + sum(c.inflight for c in self._children))

    def cancel_all(self) -> None:
        """Cancel every task in this subtree."""
        for t in list(self._tasks):
            t.cancel()
        for c in self._children:
            c.cancel_all()

    def _close_tree(self) -> None:
        self._closed = True
        for c in self._children:
            c._close_tree()

    def _tree_tasks(self) -> list:
        out = list(self._tasks)
        for c in self._children:
            out.extend(c._tree_tasks())
        return [t for t in out if not t.done()]

    async def join(self, graceful_timeout: Optional[float] = None) -> None:
        """Drain: wait for inflight work (up to ``graceful_timeout``), then
        cancel the stragglers. Covers the WHOLE subtree (children,
        grandchildren, …). The subtree refuses new spawns afterwards."""
        self._close_tree()
        pending = self._tree_tasks()
        if pending and graceful_timeout != 0:
            done, pending_set = await asyncio.wait(
                pending, timeout=graceful_timeout)
            pending = list(pending_set)
        if pending:
            logger.warning("tracker %s: cancelling %d straggler task(s)",
                           self.name, len(pending))
            for t in pending:
                t.cancel()
            await asyncio.gather(*pending, return_exceptions=True)
