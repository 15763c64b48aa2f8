"""Red-black tree keyed by uint32 hash with a (val, name) payload.

Reference: lib/rbtree.js — a top-down red-black tree specialized for the
hash ring, with ``lowerBound``/``upperBound`` (rbtree.js:235-271), ``min``
(:274-285) and an in-order iterator holding an explicit ancestor stack
(:291-342).  The behavior contract reproduced here:

* ``lower_bound(v)`` — iterator positioned at the first node with
  ``val >= v`` (cursor ``None`` when every node is smaller);
* ``upper_bound(v)`` — the reference's upperBound advances its lowerBound
  only past nodes strictly smaller than ``v``, so it lands on the first
  node ``>= v`` too (equality-inclusive — this is what ring.js:139-140
  relies on for ``lookup``);
* ``remove`` of a two-child node replaces it with its in-order successor's
  val AND name — copying only one field was the reference's "payload copy
  bug" regression (test/rbtree_test.js:594);
* duplicate ``val`` inserts are rejected (insert returns False).

The balancing scheme is a left-leaning red-black tree (recursive
insert/delete with fix-ups) rather than the reference's top-down
double-rotation scheme — same O(log n) bounds, considerably less code;
the tree shape is an implementation detail the contract doesn't cover.

The default ``HashRing`` (hashring.py) uses a sorted array instead, which
maps directly onto the device ``searchsorted`` kernel; ``RBRing`` below is
the tree-backed equivalent used to cross-check lookup semantics.

The port of ``ringpop_tpu/rbtree.py``, unchanged: host Python, no tensor.
``RBRing`` takes its hash as the reference's does; the port's is
``ops.farmhash.farmhash32``.
"""

from __future__ import annotations

from typing import Iterator, Optional


class RingNode:
    """Payload node: replica hash value + owning server name."""

    __slots__ = ("val", "name", "left", "right", "red")

    def __init__(self, val: int, name: str):
        self.val = val
        self.name = name
        self.left: Optional["RingNode"] = None
        self.right: Optional["RingNode"] = None
        self.red = True


def _is_red(node: Optional[RingNode]) -> bool:
    return node is not None and node.red


def _rotate_left(h: RingNode) -> RingNode:
    x = h.right
    h.right = x.left
    x.left = h
    x.red = h.red
    h.red = True
    return x


def _rotate_right(h: RingNode) -> RingNode:
    x = h.left
    h.left = x.right
    x.right = h
    x.red = h.red
    h.red = True
    return x


def _flip_colors(h: RingNode) -> None:
    h.red = not h.red
    h.left.red = not h.left.red
    h.right.red = not h.right.red


def _fix_up(h: RingNode) -> RingNode:
    if _is_red(h.right) and not _is_red(h.left):
        h = _rotate_left(h)
    if _is_red(h.left) and _is_red(h.left.left):
        h = _rotate_right(h)
    if _is_red(h.left) and _is_red(h.right):
        _flip_colors(h)
    return h


def _move_red_left(h: RingNode) -> RingNode:
    _flip_colors(h)
    if _is_red(h.right.left):
        h.right = _rotate_right(h.right)
        h = _rotate_left(h)
        _flip_colors(h)
    return h


def _move_red_right(h: RingNode) -> RingNode:
    _flip_colors(h)
    if _is_red(h.left.left):
        h = _rotate_right(h)
        _flip_colors(h)
    return h


def _min_node(h: RingNode) -> RingNode:
    while h.left is not None:
        h = h.left
    return h


class RBIterator:
    """In-order iterator with an explicit ancestor stack (rbtree.js:291-342).

    ``cursor`` is None both before the first ``next()`` and past the end;
    ``val()``/``name()`` return None at those positions.
    """

    def __init__(self, tree: "RBTree"):
        self.tree = tree
        self.ancestors: list[RingNode] = []
        self.cursor: Optional[RingNode] = None

    def val(self) -> Optional[int]:
        return self.cursor.val if self.cursor is not None else None

    def name(self) -> Optional[str]:
        return self.cursor.name if self.cursor is not None else None

    def _descend_min(self, node: RingNode) -> None:
        while node.left is not None:
            self.ancestors.append(node)
            node = node.left
        self.cursor = node

    def next(self) -> Optional[RingNode]:
        if self.cursor is None:
            self.ancestors = []
            if self.tree.root is not None:
                self._descend_min(self.tree.root)
        elif self.cursor.right is not None:
            self.ancestors.append(self.cursor)
            self._descend_min(self.cursor.right)
        else:
            came_from = self.cursor
            self.cursor = None
            while self.ancestors:
                parent = self.ancestors.pop()
                if parent.left is came_from:
                    self.cursor = parent
                    break
                came_from = parent
        return self.cursor


class RBTree:
    def __init__(self) -> None:
        self.root: Optional[RingNode] = None
        self.size = 0
        self._flag = False

    # -- queries -------------------------------------------------------------

    def find(self, val: int) -> Optional[RingNode]:
        node = self.root
        while node is not None:
            if val == node.val:
                return node
            node = node.left if val < node.val else node.right
        return None

    def min(self) -> Optional[RingNode]:
        return _min_node(self.root) if self.root is not None else None

    def iterator(self) -> RBIterator:
        return RBIterator(self)

    def lower_bound(self, val: int) -> RBIterator:
        """Iterator at the first node with ``val >= val`` (rbtree.js:234-259)."""
        it = RBIterator(self)
        node = self.root
        while node is not None:
            if val == node.val:
                it.cursor = node
                return it
            it.ancestors.append(node)
            node = node.right if val > node.val else node.left
        # No exact match: unwind to the deepest ancestor still >= val.
        for i in range(len(it.ancestors) - 1, -1, -1):
            node = it.ancestors[i]
            if val < node.val:
                it.cursor = node
                del it.ancestors[i:]
                return it
        it.ancestors.clear()
        return it

    def upper_bound(self, val: int) -> RBIterator:
        """First node ``>= val`` — equality-INCLUSIVE, matching the
        reference's upperBound (rbtree.js:261-270), whose advance loop only
        skips nodes strictly below ``val``.  ring.js lookup depends on a key
        hashing exactly onto a replica point owning itself."""
        return self.lower_bound(val)

    def __iter__(self) -> Iterator[RingNode]:
        it = self.iterator()
        while it.next() is not None:
            yield it.cursor

    # -- insert --------------------------------------------------------------

    def insert(self, val: int, name: str) -> bool:
        """Insert; reject duplicate vals (returns False)."""
        self._flag = False
        self.root = self._insert(self.root, val, name)
        self.root.red = False
        if self._flag:
            self.size += 1
        return self._flag

    def _insert(self, h: Optional[RingNode], val: int, name: str) -> RingNode:
        if h is None:
            self._flag = True
            return RingNode(val, name)
        if val == h.val:
            return h
        if val < h.val:
            h.left = self._insert(h.left, val, name)
        else:
            h.right = self._insert(h.right, val, name)
        return _fix_up(h)

    # -- remove --------------------------------------------------------------

    def remove(self, val: int) -> bool:
        if self.find(val) is None:
            return False
        if not _is_red(self.root.left) and not _is_red(self.root.right):
            self.root.red = True
        self.root = self._remove(self.root, val)
        if self.root is not None:
            self.root.red = False
        self.size -= 1
        return True

    def _remove(self, h: RingNode, val: int) -> Optional[RingNode]:
        if val < h.val:
            if not _is_red(h.left) and not _is_red(h.left.left):
                h = _move_red_left(h)
            h.left = self._remove(h.left, val)
        else:
            if _is_red(h.left):
                h = _rotate_right(h)
            if val == h.val and h.right is None:
                return None
            if not _is_red(h.right) and not _is_red(h.right.left):
                h = _move_red_right(h)
            if val == h.val:
                successor = _min_node(h.right)
                # Copy the WHOLE payload — val and name together
                # (the reference's payload-copy regression,
                # test/rbtree_test.js:594).
                h.val = successor.val
                h.name = successor.name
                h.right = self._remove_min(h.right)
            else:
                h.right = self._remove(h.right, val)
        return _fix_up(h)

    def _remove_min(self, h: RingNode) -> Optional[RingNode]:
        if h.left is None:
            return None
        if not _is_red(h.left) and not _is_red(h.left.left):
            h = _move_red_left(h)
        h.left = self._remove_min(h.left)
        return _fix_up(h)

    # -- invariants (for tests) ----------------------------------------------

    def check_invariants(self) -> int:
        """Validate BST order + red-black invariants; return black height."""
        def walk(node: Optional[RingNode],
                 lo: float, hi: float) -> int:
            if node is None:
                return 1
            assert lo < node.val < hi, "BST order violated"
            if node.red:
                assert not _is_red(node.left) and not _is_red(node.right), \
                    "red node with red child"
            lh = walk(node.left, lo, node.val)
            rh = walk(node.right, node.val, hi)
            assert lh == rh, "unequal black heights"
            return lh + (0 if node.red else 1)

        assert not _is_red(self.root), "red root"
        return walk(self.root, float("-inf"), float("inf"))


class RBRing:
    """Tree-backed consistent-hash ring core: the reference's exact shape
    (lib/ring.js over lib/rbtree.js).  Used to cross-check the default
    sorted-array ``HashRing``; same lookup/lookupN contract."""

    def __init__(self, hash_func, replica_points: int = 100):
        self.tree = RBTree()
        self.hash_func = hash_func
        self.replica_points = replica_points
        self.servers: set[str] = set()

    def add_server(self, name: str) -> None:
        if name in self.servers:
            return
        self.servers.add(name)
        for i in range(self.replica_points):
            self.tree.insert(self.hash_func(f"{name}{i}"), name)

    def remove_server(self, name: str) -> None:
        if name not in self.servers:
            return
        self.servers.discard(name)
        for i in range(self.replica_points):
            self.tree.remove(self.hash_func(f"{name}{i}"))

    def lookup(self, key: str) -> Optional[str]:
        if self.tree.size == 0:
            return None
        it = self.tree.upper_bound(self.hash_func(key))
        if it.cursor is None:
            return self.tree.min().name  # wraparound (ring.js:142-145)
        return it.cursor.name

    def lookup_n(self, key: str, n: int) -> list[str]:
        """Successive unique owners with wraparound (ring.js:150-182)."""
        n = min(n, len(self.servers))
        if n <= 0 or self.tree.size == 0:
            return []
        result: list[str] = []
        seen: set[str] = set()
        it = self.tree.upper_bound(self.hash_func(key))
        visited = 0
        while len(result) < n and visited < self.tree.size:
            if it.cursor is None:
                it = self.tree.iterator()
                it.next()  # wrap to min
                if it.cursor is None:
                    break
            if it.cursor.name not in seen:
                seen.add(it.cursor.name)
                result.append(it.cursor.name)
            it.next()
            visited += 1
        return result
